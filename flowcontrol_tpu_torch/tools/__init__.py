"""Host tools that make the port's committed inputs (controllers, modes)."""

"""Core layers of the port: init, functional primitives, the Model base."""

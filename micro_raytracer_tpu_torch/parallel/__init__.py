"""Training steps over the port's differentiable trace (one device)."""

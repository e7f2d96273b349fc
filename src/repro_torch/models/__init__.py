"""Models of the port (ENet)."""

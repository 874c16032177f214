"""Model factories of the port."""

"""Data preprocessing of the port."""

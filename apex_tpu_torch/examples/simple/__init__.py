"""The minimal data-parallel example of the port."""

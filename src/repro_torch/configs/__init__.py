"""Model and table configurations of the port."""

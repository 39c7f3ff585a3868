"""Operation and byte counts, and the published peaks."""

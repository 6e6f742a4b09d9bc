"""Architecture configs (copies of the reference package's)."""

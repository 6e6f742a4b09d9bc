"""Flash attention for chunked prefill against the paged cache."""

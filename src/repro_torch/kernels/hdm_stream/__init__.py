"""Paged weight-streaming matmul: ``x @ vstack(w_pages[page_ids])``."""

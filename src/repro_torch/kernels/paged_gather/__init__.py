"""Cross-rank paged gather on the stacked rank axis: the plain version
(`ref`) and the kernel wrapper (`ops`)."""

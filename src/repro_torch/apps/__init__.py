"""Applications of the one-sided layer (the paper's application studies)."""

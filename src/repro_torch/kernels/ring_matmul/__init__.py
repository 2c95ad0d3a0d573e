"""The fused all-gather matmul on the rank axis: the plain versions (`ref`)
and the kernel wrapper (`ops`)."""

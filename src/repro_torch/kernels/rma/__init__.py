"""One-sided RMA kernels on the stacked rank axis: plain versions (`ref`)
and kernel wrappers (`ops`)."""

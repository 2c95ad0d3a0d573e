"""repro_torch.launch — command-line entry points (`serve`, `train`,
`dryrun`, `roofline`) and the cost counter over torch ops (`hlo_cost`)."""

"""repro_torch.serve — disaggregated prefill/decode serving (`disagg`)."""

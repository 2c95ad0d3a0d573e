"""repro_torch.serve — disaggregated prefill/decode serving (`disagg`) and
the continuous-batching engine (`engine`)."""

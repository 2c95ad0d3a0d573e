"""Applications of the one-sided layer: the paper's application studies.

  * `milc` — the MILC 4-D lattice stencil with a PSCW halo exchange (§4.4);
  * `fft`  — the 3-D FFT with a one-sided transpose, pencil and
    plane-by-plane schedules (§4.3).

The other two studies are in `repro_torch.core`: the distributed hashtable
(`core.hashtable`, §4.1) and the dynamic sparse data exchange (`core.dsde`,
§4.2).
"""

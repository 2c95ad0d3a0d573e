"""repro_torch.rmaq — notified-access message channels over RMA windows.

  * `queue`   — fixed-capacity MPSC ring per window rank with rank-ordered
    fetch-and-add slot reservation, wraparound, backpressure and drain;
  * `channel` — typed multi-lane channels multiplexed over one queue;
  * `flow`    — credit-based flow control over the channel lanes.
"""

from . import channel, flow, queue  # noqa: F401

__all__ = ["channel", "flow", "queue"]

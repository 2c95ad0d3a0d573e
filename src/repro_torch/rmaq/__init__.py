"""repro_torch.rmaq — notified-access message channels over RMA windows.

  * `queue`   — fixed-capacity MPSC ring per window rank with rank-ordered
    fetch-and-add slot reservation, wraparound, backpressure and drain;
  * `channel` — typed multi-lane channels multiplexed over one queue;
  * `flow`    — credit-based flow control over the channel lanes;
  * `notify`  — put-with-notification, counter accumulate, the rank-ordered
    fetch-and-add and the credit fetch.
"""

from . import channel, flow, notify, queue  # noqa: F401

__all__ = ["channel", "flow", "notify", "queue"]

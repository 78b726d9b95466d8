"""Multi-object trackers (ByteTrack, BoT-SORT) on the port's Results: host-side numpy and scipy."""

from ultralytics_pro_tpu_torch.trackers.bot_sort import BOTSORT
from ultralytics_pro_tpu_torch.trackers.byte_tracker import BYTETracker

__all__ = ["BOTSORT", "BYTETracker"]

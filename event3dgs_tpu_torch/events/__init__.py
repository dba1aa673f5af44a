"""Event-camera subsystem: data model, codecs, DVS simulation, metrics.

Counterpart of ``event3dgs_tpu/events/`` (and of the reference's
`Event_sensor/` package, SURVEY §2.2): a SoA event buffer, Prophesee
`.dat`/CSV/HDF5 codecs, a vectorized numpy DVS simulator (with a C++ twin
in `events/native/`, built with g++ on first use), event-frame accumulation
in torch on a device, readout arbiters, and event-stream distance metrics.
"""

from event3dgs_tpu_torch.events.buffer import EventBuffer
from event3dgs_tpu_torch.events.dvs_model import DvsSimulator, DvsParams
from event3dgs_tpu_torch.events.accumulate import (
    accumulation_frame,
    polarity_frame,
    event_count_image,
)

__all__ = [
    "EventBuffer",
    "DvsSimulator",
    "DvsParams",
    "accumulation_frame",
    "polarity_frame",
    "event_count_image",
]

"""The pressure/telemetry vocabulary of the MVGC stack (port of
``repro.core.telemetry``).

Only what the serving slice uses: :class:`PressureSignal` (the gate output,
fields are tensors), :class:`ReclaimStats` (host-side counters behind the
engine's BENCH_serve counter names) and :class:`GCConfig` (the GC knobs of
the paged cache and its engine in one frozen dataclass).  The
kernel-dispatch knobs of the JAX config (``use_kernel``,
``kernel_interpret``) have no counterpart: the port dispatches on the
tensor's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple


class PressureSignal(NamedTuple):
    """Unified capacity-gate output.

    ======================  ======================================  =========
    field                   vstore (descriptor slabs)               paged pool
    ======================  ======================================  =========
    ``level``               max(slab frac, ring frac)               1 - free frac
    ``under_pressure``      either watermark crossed                below watermark
    ``deficit``             versions to free                        pages to free
    ``live``                live versions                           live pages
    ``capacity``            slots x versions_per_slot               pool pages
    ======================  ======================================  =========
    """

    level: Any            # f32 0..1 resource-fullness (1.0 = exhausted)
    under_pressure: Any   # bool: a watermark is crossed — reclaim now
    deficit: Any          # i32 units (versions/pages) to free to clear it
    live: Any             # i32 currently-live units
    capacity: Any         # i32 total units the resource can hold


@dataclasses.dataclass
class ReclaimStats:
    """Host-side reclamation accounting (``unit`` names what ``reclaimed``
    and ``peak_live`` count)."""

    unit: str = "pages"
    pressure_events: int = 0        # gate triggers (failed op or watermark)
    reclaims_triggered: int = 0     # synchronous reclaim passes actually run
    reclaimed: int = 0              # units returned to the free pool
    give_ups: int = 0               # lanes abandoned after max reclaim rounds
    peak_live: int = 0              # max live units ever observed
    peak_live_post_reclaim: int = 0  # max live units right after a reclaim
    ckpt_evictions: int = 0         # sole-survivor evictions
    ckpt_freed: int = 0             # units freed by checkpoint eviction alone

    def note_event(self) -> None:
        """One pressure event — the trigger, not the response."""
        self.pressure_events += 1

    def note_reclaim(self, freed: int, live_after: int) -> None:
        """One synchronous reclaim pass that freed ``freed`` units."""
        self.reclaims_triggered += 1
        self.reclaimed += max(0, int(freed))
        self.peak_live_post_reclaim = max(self.peak_live_post_reclaim,
                                          int(live_after))

    def note_ckpt_eviction(self, evicted: int, freed: int) -> None:
        """One checkpoint-eviction pass."""
        self.ckpt_evictions += max(0, int(evicted))
        self.ckpt_freed += max(0, int(freed))

    def note_live(self, live: int) -> None:
        """Track the all-time live peak."""
        self.peak_live = max(self.peak_live, int(live))


@dataclasses.dataclass(frozen=True)
class GCConfig:
    """The GC/pressure knobs of the paged cache and its engine."""

    policy: str = "slrt"            # ebr | steam | dlrt | slrt | sweep
    versions_per_slot: int = 8      # descriptor slab depth
    reader_lanes: int = 8           # announcement-board lanes
    ring_capacity: int = 0          # retire ring; 0 = sized from the store
    page_watermark: float = 0.25    # paged-pool free-fraction threshold
    hot_k: int = 8                  # hot-slot count for targeted reclaim
    max_reclaim_rounds: int = 3     # reclaim-and-retry attempts per step


"""Host side of the state-health probes (port of the JAX package's
``telemetry/probes.py``; the in-chunk half is ``ops/statehealth.py``):

* :class:`ProbeConfig`, the tier knob (``off`` / ``counters`` /
  ``moments``), frozen and hashable, so a cache of built chunks can key
  on it; ``off`` is the default and runs the unprobed chunk;
* :func:`record_probe_steps`, one ``state_health`` journal event per
  step of a chunk, from host values already read back;
* :func:`summarize_host`, the NumPy mirror of the in-chunk summary,
  counter for counter, for steps run eagerly.

The ``nan_detected``, ``conservation_drift`` and ``bounds_violation``
health rules (:mod:`.health`) read these events. NumPy only.
"""

# gridlint: scrape-path

from __future__ import annotations

import dataclasses

import numpy as np

#: Probe tiers, cheapest first.
TIERS = ("off", "counters", "moments")


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Static probe configuration: ``tier`` selects what the chunk
    computes; ``lo``/``hi`` bound the box the ``oob`` counter checks
    positions against (``[0, 1)`` for the service's unit box)."""

    tier: str = "off"
    lo: float = 0.0
    hi: float = 1.0

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(
                f"unknown probe tier {self.tier!r} (choose from {TIERS})"
            )
        if not self.hi > self.lo:
            raise ValueError(
                f"probe bounds must satisfy lo < hi, got "
                f"[{self.lo}, {self.hi})"
            )

    @property
    def armed(self) -> bool:
        return self.tier != "off"

    @property
    def moments(self) -> bool:
        return self.tier == "moments"


def record_probe_steps(recorder, first_step: int, probe) -> int:
    """Journal a chunk's ``ys["probe"]`` (leaves ``[chunk]`` or
    ``[chunk, ndim]``, already on the host) as one ``state_health`` event
    a step, numbered ``first_step, first_step + 1, ...``. Returns the
    number of events."""
    live = np.asarray(probe["live"])
    nan_pos = np.asarray(probe["nan_pos"])
    nan_vel = np.asarray(probe["nan_vel"])
    oob = np.asarray(probe["oob"])
    residual = np.asarray(probe["residual"])
    pos_min = probe.get("pos_min")
    pos_max = probe.get("pos_max")
    vel_m2 = probe.get("vel_m2")
    n = int(live.shape[0])
    for i in range(n):
        extra = {}
        if pos_min is not None:
            extra["pos_min"] = [float(x) for x in np.asarray(pos_min)[i]]
            extra["pos_max"] = [float(x) for x in np.asarray(pos_max)[i]]
            extra["vel_m2"] = float(np.asarray(vel_m2)[i])
        recorder.record(
            "state_health",
            step=int(first_step) + i,
            live=int(live[i]),
            nan_pos=int(nan_pos[i]),
            nan_vel=int(nan_vel[i]),
            oob=int(oob[i]),
            residual=int(residual[i]),
            **extra,
        )
    return n


def summarize_host(pos, vel, count, initial_live, cum_dropped,
                   cfg: ProbeConfig) -> dict:
    """NumPy mirror of ``ops.statehealth.summarize``: one
    ``state_health`` payload (host scalars) from prefix-valid ``[R *
    cap, ndim]`` state, counter-exact against the in-chunk pass."""
    pos = np.asarray(pos)
    vel = np.asarray(vel)
    count = np.asarray(count)
    cap = pos.shape[0] // count.shape[0]
    mask = (
        np.arange(cap, dtype=np.int32)[None, :] < count[:, None]
    ).reshape(-1)
    with np.errstate(invalid="ignore"):
        bad_pos = ~np.isfinite(pos)
        bad_vel = ~np.isfinite(vel)
        out = (pos < cfg.lo) | (pos >= cfg.hi)
    live = int(count.sum())
    payload = {
        "live": live,
        "nan_pos": int(np.sum(np.any(bad_pos, axis=-1) & mask)),
        "nan_vel": int(np.sum(np.any(bad_vel, axis=-1) & mask)),
        "oob": int(np.sum(np.any(out, axis=-1) & mask)),
        "residual": live + int(cum_dropped) - int(initial_live),
    }
    if cfg.moments:
        m = mask[:, None]
        posf = pos.astype(np.float32)
        velf = vel.astype(np.float32)
        payload["pos_min"] = [
            float(x)
            for x in np.min(np.where(m, posf, np.float32(np.inf)), axis=0)
        ]
        payload["pos_max"] = [
            float(x)
            for x in np.max(np.where(m, posf, np.float32(-np.inf)), axis=0)
        ]
        payload["vel_m2"] = float(
            np.sum(np.where(m, velf * velf, np.float32(0.0)))
        )
    return payload

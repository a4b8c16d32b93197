"""Engine names and their resolution (port of the JAX package's
``parallel/exchange.py`` ``ENGINES`` and ``resolve_engine``; the
canonical exchange engines themselves are not ported yet)."""

from __future__ import annotations

ENGINES = (
    "auto", "planar", "rowmajor", "sparse", "neighbor", "hierarchical"
)


def resolve_engine(
    engine: str,
    *,
    vranks: bool = False,
    n_devices: int = 1,
    planar_ok: bool = True,
    canonical: bool = False,
    n_pods: int = 1,
    recorder=None,
) -> str:
    """Resolve a user-facing engine name to a concrete engine, by the
    reference's one rule for both surfaces.

    Canonical exchange (``canonical=True``): ``"auto"`` picks
    ``"hierarchical"`` on a multi-pod multi-device mesh, ``"sparse"`` on
    other multi-device meshes, ``"planar"`` on one device and
    ``"rowmajor"`` when the payload is not planar-eligible (``planar_ok``
    False); explicit names are honoured, ``"hierarchical"`` degrading to
    ``"sparse"`` on a flat mesh.

    Migrate loop (``canonical=False``): ``"auto"``/``"sparse"`` give the
    mover-sparse engine exactly on a single-device vrank step (``vranks``
    and ``n_devices == 1``), ``"planar"`` otherwise; the canonical-only
    names raise ``ValueError``.

    ``recorder`` (the reference journals the decision) raises
    ``NotImplementedError``: the telemetry plane is not ported yet."""
    if engine not in ENGINES:
        raise ValueError(
            f"engine must be one of {ENGINES}, got {engine!r}"
        )
    if recorder is not None:
        raise NotImplementedError(
            "resolve_engine(recorder=...): engine journaling belongs to the "
            "telemetry plane, which is not ported yet (ROADMAP.md A11)"
        )
    if canonical:
        if engine in ("rowmajor", "planar", "neighbor", "sparse"):
            return engine
        if engine == "hierarchical":
            return "hierarchical" if n_pods > 1 else "sparse"
        if not planar_ok:
            return "rowmajor"
        if n_devices > 1 and n_pods > 1:
            return "hierarchical"
        if n_devices > 1:
            return "sparse"
        return "planar"
    if engine in ("rowmajor", "neighbor", "hierarchical"):
        raise ValueError(
            f"engine={engine!r} is a canonical-exchange engine; the "
            "migrate loop accepts 'auto', 'sparse' or 'planar'"
        )
    if engine in ("auto", "sparse") and vranks and n_devices == 1:
        return "sparse"
    return "planar"

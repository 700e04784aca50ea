"""What the program counted inside its spans while a torch.profiler session
recorded: its `utils.profiling.PROFILED` (host waits on the card by site,
bus bytes by kind, seconds by span). In a run of the harness only the
profiled window records, so these are that window's; a process that ran two
profiled windows holds both. Empty where the program keeps no such counts."""


def counts(key: str) -> dict:
    """PROFILED[key] of the program ("syncs", "bus_bytes" or "span_s"), or {}."""
    try:
        from simd_minimizers_tpu_torch.utils import profiling
    except ImportError:
        return {}
    return dict(getattr(profiling, "PROFILED", {}).get(key, {}))

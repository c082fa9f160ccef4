"""The trace plane and the analysis that reads it — the port of
``horovod_tpu/timeline/``: the per-rank communication timeline
(``timeline.py``), the model-DAG recorder (``recorder.py``), the
compute-anatomy profiler (``profiler.py``), the cross-rank merge
(``merge.py``), the α–β comm model (``comm_report.py``) and the dPRO
replay engine (``replay/``)."""

from .timeline import Timeline, timeline  # noqa: F401

#: the lazily imported submodules: the hot-path timeline does not import
#: the recorder (torch.fx), the profiler or the analysis side at package
#: load, as in the reference
_SUBMODULES = ("profiler", "recorder", "merge", "comm_report", "replay")


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in ("Recorder", "TimelineHook"):
        from . import recorder

        return getattr(recorder, name)
    if name == "ComputeProfiler":
        from . import profiler

        return profiler.ComputeProfiler
    if name in ("merge_traces", "straggler_report"):
        from . import merge

        return getattr(merge, name)
    if name in ("TopologySpec", "predict_collective_us",
                "collective_report"):
        from . import comm_report

        return getattr(comm_report, name)
    if name == "analyze":
        from . import replay

        return replay.analyze
    raise AttributeError(name)

"""The trace plane: the per-rank communication timeline
(``timeline.py``), the model-DAG recorder (``recorder.py``) and the
compute-anatomy profiler (``profiler.py``) — the port of
``horovod_tpu/timeline/``.  The comm model, the replay engine and the
cross-rank merge are not ported yet."""

from .timeline import Timeline, timeline  # noqa: F401


def __getattr__(name):
    # lazy, as in the reference: the hot-path timeline does not import
    # the recorder (torch.fx) or the profiler at package load
    if name in ("Recorder", "TimelineHook"):
        from . import recorder

        return getattr(recorder, name)
    if name == "ComputeProfiler":
        from . import profiler

        return profiler.ComputeProfiler
    if name == "profiler":
        import importlib

        return importlib.import_module(".profiler", __name__)
    raise AttributeError(name)

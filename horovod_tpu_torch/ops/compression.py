"""Gradient compression: the stateless cast pair of
``horovod_tpu/ops/compression.py`` (``NoneCompressor``,
``BF16Compressor``, ``Compression.none/.bf16/.fp16``).  The scaled
quantizers and error feedback come in a later slice; asking for them
raises."""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import env as env_util


def _compressible(tensor: torch.Tensor) -> bool:
    """Only floating tensors are cast; integer and bool tensors pass
    through untouched (casting them would corrupt data, not round it)."""
    return tensor.is_floating_point()


class Compressor:
    """Interface for compressing and decompressing a given tensor."""

    name = "none"

    @staticmethod
    def compress(tensor):
        """Returns ``(compressed_tensor, context)``."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    name = "none"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class BF16Compressor(Compressor):
    """Cast to bfloat16 for the collective, cast back after."""

    name = "bf16"

    @staticmethod
    def compress(tensor):
        if not _compressible(tensor):
            return tensor, None
        return tensor.to(torch.bfloat16), tensor.dtype

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            return tensor.to(ctx)
        return tensor


_REGISTRY = {"none": NoneCompressor, "bf16": BF16Compressor,
             "fp16": BF16Compressor}
_LATER = ("int8", "fp8", "fp8_e4m3", "fp8_e5m2")


class Compression:
    """The built-in wire formats; ``fp16`` is an alias of ``bf16`` as in
    the reference."""

    none = NoneCompressor
    fp16 = BF16Compressor
    bf16 = BF16Compressor

    @staticmethod
    def lookup(name: Optional[str], error_feedback: bool = False):
        """Resolve a registry name (None/'' → none).  Quantizers and error
        feedback raise ``NotImplementedError``: they are a later slice."""
        key = str(name).strip().lower() if name else "none"
        if key.startswith("ef_"):
            key, error_feedback = key[3:], True
        if key in _LATER:
            raise NotImplementedError(
                f"compression {name!r} is not ported yet (the quantizers "
                "come with the wire-tier slice)")
        try:
            comp = _REGISTRY[key]
        except KeyError:
            raise ValueError(
                f"unknown compression {name!r}; ported: "
                f"{', '.join(sorted(_REGISTRY))}") from None
        if error_feedback and comp is not NoneCompressor:
            raise NotImplementedError(
                "error-feedback compression is not ported yet (it comes "
                f"with the wire-tier slice); set "
                f"{env_util.HVD_COMPRESSION_ERROR_FEEDBACK}=0 for the "
                "stateless cast")
        return comp


def from_env():
    """The job-level choice, read as the reference reads it:
    ``HVD_COMPRESSION``, error-feedback-wrapped unless
    ``HVD_COMPRESSION_ERROR_FEEDBACK=0``."""
    name = env_util.get_str(env_util.HVD_COMPRESSION, "none")
    ef = env_util.get_bool(env_util.HVD_COMPRESSION_ERROR_FEEDBACK, True)
    return Compression.lookup(name, error_feedback=ef)

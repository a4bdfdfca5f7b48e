"""Model-update compression service (port of ``fl_tpu.fl.compression``).

Pluggable algorithms behind one service with self-describing packages,
numpy in and numpy out:

- ``zlib``   byte-level DEFLATE of the npz-packed arrays;
- ``lz4``    the LZ4 block of the same bytes by the native codec
             (``fl_tpu_torch.native``), zlib where no C++ toolchain is;
- ``quantization``  1-32-bit affine/symmetric quantization per tensor
             (``fl_tpu_torch.ops.quantize.quantize_affine``), packed on the
             host;
- ``top_k``  top-k sparsification per tensor (``fl_tpu_torch.ops.topk``).

The package format is the reference's: ``np.savez`` framing, the same
array names and metadata keys, so either package decodes the other's
payloads. No pickle: the payloads come from clients.
"""

from __future__ import annotations

import io
import time
import zlib
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from fl_tpu_torch import native
from fl_tpu_torch.ops.quantize import dequantize_affine, quantize_affine
from fl_tpu_torch.ops.topk import topk_densify, topk_sparsify_ratio

ModelWeightsNP = Dict[str, np.ndarray]


class CompressionError(Exception):
    pass


def _pack_arrays(arrays: Mapping[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def _unpack_arrays(data: bytes) -> ModelWeightsNP:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _flat_f32(w) -> torch.Tensor:
    return torch.from_numpy(np.array(w, np.float32).ravel())


class ZlibCompressor:
    """Lossless byte compressor (stdlib DEFLATE)."""

    name = "zlib"

    def __init__(self, level: int = 1):
        self.level = level

    def compress(self, weights: ModelWeightsNP) -> Tuple[bytes, Dict[str, Any]]:
        raw = _pack_arrays(weights)
        comp = zlib.compress(raw, self.level)
        return comp, {
            "algorithm": self.name,
            "level": self.level,
            "original_size": len(raw),
            "compressed_size": len(comp),
        }

    def decompress(self, payload: bytes, metadata: Dict[str, Any]
                   ) -> ModelWeightsNP:
        return _unpack_arrays(zlib.decompress(payload))


class LZ4Compressor:
    """Lossless LZ4-block compressor backed by the first-party native codec
    (``fl_tpu_torch/native/fl_codec.cpp``). Falls back to zlib when no C++
    toolchain is available; the metadata's ``backend`` records which codec
    produced the payload, so decompression always dispatches correctly."""

    name = "lz4"

    def compress(self, weights: ModelWeightsNP) -> Tuple[bytes, Dict[str, Any]]:
        raw = _pack_arrays(weights)
        if native.available():
            comp = native.lz4_compress(raw)
            backend = "native"
        else:
            comp = zlib.compress(raw, 1)
            backend = "zlib-fallback"
        return comp, {
            "algorithm": self.name,
            "backend": backend,
            "original_size": len(raw),
            "compressed_size": len(comp),
        }

    def decompress(self, payload: bytes, metadata: Dict[str, Any]
                   ) -> ModelWeightsNP:
        if metadata.get("backend", "native") == "native":
            raw = native.lz4_decompress(payload)
        else:
            raw = zlib.decompress(payload)
        return _unpack_arrays(raw)


class QuantizationCompressor:
    """Lossy N-bit quantization per tensor."""

    name = "quantization"

    def __init__(self, bits: int = 8, symmetric: bool = False):
        if not (1 <= bits <= 32):
            raise CompressionError("bits must be in [1, 32]")
        self.bits = bits
        self.symmetric = symmetric

    def compress(self, weights: ModelWeightsNP) -> Tuple[bytes, Dict[str, Any]]:
        packed: Dict[str, np.ndarray] = {}
        per_tensor: Dict[str, Any] = {}
        for k, w in weights.items():
            q, scale, zp = quantize_affine(_flat_f32(w), self.bits,
                                           self.symmetric)
            if self.symmetric:  # range [-2^(b-1), 2^(b-1)-1]
                store_dtype = (np.int8 if self.bits <= 8
                               else np.int16 if self.bits <= 16 else np.int32)
            else:  # range [0, 2^b - 1] needs unsigned storage
                store_dtype = (np.uint8 if self.bits <= 8
                               else np.uint16 if self.bits <= 16 else np.uint32)
            packed[f"{k}::q"] = q.numpy().astype(store_dtype)
            per_tensor[k] = {
                "scale": float(scale),
                "zero_point": float(zp),
                "shape": list(np.shape(w)),
                "dtype": str(np.asarray(w).dtype),
            }
        raw = _pack_arrays(packed)
        comp = zlib.compress(raw, 1)
        return comp, {
            "algorithm": self.name,
            "bits": self.bits,
            "symmetric": self.symmetric,
            "tensors": per_tensor,
            "original_size": sum(
                int(np.prod(v["shape"])) * 4 for v in per_tensor.values()
            ),
            "compressed_size": len(comp),
        }

    def decompress(self, payload: bytes, metadata: Dict[str, Any]
                   ) -> ModelWeightsNP:
        packed = _unpack_arrays(zlib.decompress(payload))
        out: ModelWeightsNP = {}
        for k, meta in metadata["tensors"].items():
            q = torch.from_numpy(
                packed[f"{k}::q"].astype(np.int64).astype(np.int32))
            arr = dequantize_affine(
                q, torch.tensor(meta["scale"], dtype=torch.float32),
                torch.tensor(meta["zero_point"], dtype=torch.float32),
                metadata["symmetric"])
            out[k] = (arr.numpy().reshape(meta["shape"])
                      .astype(meta["dtype"]))
        return out


class TopKSparsificationCompressor:
    """Keep the top-k elements by magnitude per tensor."""

    name = "top_k"

    def __init__(self, sparsity_ratio: float = 0.9):
        if not (0.0 <= sparsity_ratio < 1.0):
            raise CompressionError("sparsity_ratio must be in [0, 1)")
        self.sparsity_ratio = sparsity_ratio

    def compress(self, weights: ModelWeightsNP) -> Tuple[bytes, Dict[str, Any]]:
        packed: Dict[str, np.ndarray] = {}
        per_tensor: Dict[str, Any] = {}
        for k, w in weights.items():
            vals, idx = topk_sparsify_ratio(_flat_f32(w), self.sparsity_ratio)
            packed[f"{k}::v"] = vals.numpy()
            packed[f"{k}::i"] = idx.numpy()
            per_tensor[k] = {
                "shape": list(np.shape(w)),
                "dtype": str(np.asarray(w).dtype),
            }
        raw = _pack_arrays(packed)
        comp = zlib.compress(raw, 1)
        return comp, {
            "algorithm": self.name,
            "sparsity_ratio": self.sparsity_ratio,
            "tensors": per_tensor,
            "original_size": sum(
                int(np.prod(v["shape"])) * 4 for v in per_tensor.values()
            ),
            "compressed_size": len(comp),
        }

    def decompress(self, payload: bytes, metadata: Dict[str, Any]
                   ) -> ModelWeightsNP:
        packed = _unpack_arrays(zlib.decompress(payload))
        out: ModelWeightsNP = {}
        for k, meta in metadata["tensors"].items():
            dense = topk_densify(torch.from_numpy(packed[f"{k}::v"]),
                                 torch.from_numpy(packed[f"{k}::i"]),
                                 int(np.prod(meta["shape"])))
            out[k] = (dense.numpy().reshape(meta["shape"])
                      .astype(meta["dtype"]))
        return out


_ALGORITHMS = {
    "zlib": ZlibCompressor,
    "lz4": LZ4Compressor,
    "quantization": QuantizationCompressor,
    "top_k": TopKSparsificationCompressor,
}


class ModelCompressionService:
    """Algorithm-dispatching facade."""

    def __init__(self, algorithm: str = "zlib", **kwargs: Any):
        if algorithm not in _ALGORITHMS:
            raise CompressionError(
                f"Unknown compression algorithm: {algorithm}. "
                f"Available: {sorted(set(_ALGORITHMS))}"
            )
        self.algorithm = algorithm
        self.compressor = _ALGORITHMS[algorithm](**kwargs)

    def compress_weights(self, weights: Mapping[str, Any]
                         ) -> Tuple[bytes, Dict[str, Any]]:
        """Returns (payload, metadata); the metadata is self-describing, so
        any service instance can decompress."""
        np_weights = {k: np.asarray(v) for k, v in weights.items()}
        payload, metadata = self.compressor.compress(np_weights)
        metadata["compression_ratio"] = (
            metadata["compressed_size"] / metadata["original_size"]
            if metadata.get("original_size") else 1.0
        )
        return payload, metadata

    def decompress_weights(self, payload: bytes, metadata: Dict[str, Any]
                           ) -> ModelWeightsNP:
        """Dispatch by the package's own algorithm field."""
        algo = metadata.get("algorithm", self.algorithm)
        if algo not in _ALGORITHMS:
            raise CompressionError(f"Unknown algorithm in package: {algo}")
        comp = (self.compressor if algo == self.algorithm
                else _ALGORITHMS[algo]())
        return comp.decompress(payload, metadata)


def create_compression_service(algorithm: str = "zlib", **kwargs: Any
                               ) -> ModelCompressionService:
    return ModelCompressionService(algorithm, **kwargs)


def benchmark_compression_algorithms(
    weights: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Dict[str, Any]]:
    """Ratio, time and fidelity of each algorithm on ``weights`` (by
    default two SimpleCNN-shaped random kernels)."""
    if weights is None:
        rng = np.random.default_rng(0)
        weights = {
            "conv1/kernel": rng.normal(0, 0.1, (3, 3, 1, 32)).astype(np.float32),
            "fc1/kernel": rng.normal(0, 0.05, (3136, 128)).astype(np.float32),
        }
    results: Dict[str, Dict[str, Any]] = {}
    for algo in ("zlib", "quantization", "top_k"):
        svc = create_compression_service(algo)
        t0 = time.perf_counter()
        payload, meta = svc.compress_weights(weights)
        t_comp = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = svc.decompress_weights(payload, meta)
        t_decomp = time.perf_counter() - t0
        max_err = max(
            float(np.abs(np.asarray(restored[k], np.float32)
                         - np.asarray(w, np.float32)).max())
            for k, w in weights.items()
        )
        results[algo] = {
            "compression_ratio": meta["compression_ratio"],
            "compression_time": t_comp,
            "decompression_time": t_decomp,
            "max_reconstruction_error": max_err,
            "lossless": max_err == 0.0,
        }
    return results

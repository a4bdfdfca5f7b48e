"""The port's wire codecs and native LZ4 codec vs fl_tpu's.

- ``fl_tpu_torch/native/fl_codec.cpp`` is the reference's source byte for
  byte, builds with g++ at first use (not at import) into
  ``fl_tpu_torch/_build/``, and gives the same LZ4 block of the same raw
  bytes as the reference's build; both packages must run the native codec
  here (``backend == "native"``), so a failed build cannot hide behind the
  zlib fallback.
- Each package decodes the other's payloads, for every compressor, to
  arrays equal to its own decoding. The payloads themselves are not
  compared: ``np.savez``'s zip entries carry timestamps.
- The hostile-payload cases of ``tests/test_native_codec.py``, on the
  port's codec.
"""

import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fl_tpu import native as jnative
from fl_tpu.fl import compression as jcomp
from fl_tpu_torch import native
from fl_tpu_torch.fl import compression as comp

ROOT = Path(__file__).resolve().parent.parent

CASES = [
    b"",
    b"a",
    b"abcd" * 10_000,
    bytes(100_000),
    np.random.default_rng(0).normal(size=25_000).astype(np.float32).tobytes(),
    np.random.default_rng(1).integers(-5, 5, 200_000).astype(np.int8).tobytes(),
    bytes(range(256)) * 300,
]

COMPRESSORS = [
    ("zlib", {}),
    ("lz4", {}),
    ("quantization", {"bits": 8}),
    ("quantization", {"bits": 8, "symmetric": True}),
    ("quantization", {"bits": 4}),
    ("quantization", {"bits": 16, "symmetric": True}),
    ("top_k", {"sparsity_ratio": 0.9}),
    ("top_k", {"sparsity_ratio": 0.5}),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_codec():
    """The reference's native codec, loaded. Test workers that collect
    ``tests/test_native_codec.py`` at once all build it where no library
    exists yet, and one that read a half-written library keeps a failed
    state; the library is whole once collection is over, so load again."""
    if not jnative.available():
        jnative._build_failed = False
    assert jnative.available()
    return jnative


def _weights():
    rng = np.random.default_rng(2)
    return {
        "conv1/kernel": rng.normal(0, 0.1, (3, 3, 1, 32)).astype(np.float32),
        "conv1/bias": np.zeros(32, np.float32),
        "fc2/kernel": rng.normal(0, 0.05, (128, 10)).astype(np.float32),
        "fc2/bias": rng.normal(0, 0.01, (10,)).astype(np.float32),
    }


def test_codec_source_is_the_reference_byte_for_byte():
    assert (ROOT / "fl_tpu_torch/native/fl_codec.cpp").read_bytes() == \
        (ROOT / "fl_tpu/native/fl_codec.cpp").read_bytes()


def test_import_builds_nothing_and_the_build_lands_in_build_dir():
    code = ("import subprocess\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError('a build ran at import')\n"
            "subprocess.run = refuse\n"
            "import fl_tpu_torch.native as n\n"
            "import fl_tpu_torch.fl.compression\n"
            "assert n._lib is None\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert native.available()
    lib = native.library_path()
    assert lib.exists() and lib.parent.parent == ROOT / "fl_tpu_torch/_build"
    assert not list((ROOT / "fl_tpu_torch/native").glob("*.so"))


@pytest.mark.parametrize("i", range(len(CASES)))
def test_lz4_block_is_byte_identical_to_the_reference(i, ref_codec):
    assert native.available()
    blob = native.lz4_compress(CASES[i])
    assert blob[:4] == native.MAGIC
    assert blob == ref_codec.lz4_compress(CASES[i])
    assert native.lz4_decompress(blob) == CASES[i]


@pytest.mark.parametrize("algo,kw", COMPRESSORS,
                         ids=[f"{a}-{'-'.join(map(str, k.values()))}"
                              for a, k in COMPRESSORS])
def test_each_package_decodes_the_others_payloads(algo, kw, ref_codec):
    w = _weights()
    mine = comp.create_compression_service(algo, **kw)
    ref = jcomp.create_compression_service(algo, **kw)
    for src, dst in ((mine, ref), (ref, mine)):
        payload, meta = src.compress_weights(w)
        if algo == "lz4":
            assert meta["backend"] == "native"
        want = src.decompress_weights(payload, meta)
        got = dst.decompress_weights(payload, meta)
        assert sorted(got) == sorted(w)
        for k in w:
            assert got[k].dtype == w[k].dtype and got[k].shape == w[k].shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the same metadata on both sides, sizes aside
    _, m1 = mine.compress_weights(w)
    _, m2 = ref.compress_weights(w)
    drop = ("compressed_size", "compression_ratio")
    assert {k: v for k, v in m1.items() if k not in drop} == \
        {k: v for k, v in m2.items() if k not in drop}


def test_benchmark_matches_the_reference():
    got = comp.benchmark_compression_algorithms()
    want = jcomp.benchmark_compression_algorithms()
    assert sorted(got) == sorted(want) == ["quantization", "top_k", "zlib"]
    for algo in got:
        assert got[algo]["lossless"] == want[algo]["lossless"]
        assert got[algo]["max_reconstruction_error"] == \
            want[algo]["max_reconstruction_error"]
        assert got[algo]["compression_ratio"] == pytest.approx(
            want[algo]["compression_ratio"], rel=1e-3)


def test_unknown_algorithms_and_bad_arguments_are_refused():
    with pytest.raises(comp.CompressionError, match="Unknown compression"):
        comp.create_compression_service("brotli")
    with pytest.raises(comp.CompressionError, match="bits"):
        comp.create_compression_service("quantization", bits=0)
    with pytest.raises(comp.CompressionError, match="sparsity_ratio"):
        comp.create_compression_service("top_k", sparsity_ratio=1.0)
    svc = comp.create_compression_service("zlib")
    payload, meta = svc.compress_weights(_weights())
    with pytest.raises(comp.CompressionError, match="Unknown algorithm"):
        svc.decompress_weights(payload, dict(meta, algorithm="brotli"))


# ---------------------------------------------------------------------------
# hostile payloads (the coordinator decompresses untrusted client bytes)
# ---------------------------------------------------------------------------

def test_lz4_rejects_garbage():
    with pytest.raises(ValueError):
        native.lz4_decompress(b"NOPE" + bytes(20))
    good = native.lz4_compress(b"hello world, hello world, hello world!")
    bad = bytearray(good)
    bad[10] ^= 0xFF
    bad[11] ^= 0xFF
    try:
        # a flip may still decode; it must never crash or over-run
        assert isinstance(native.lz4_decompress(bytes(bad)), bytes)
    except ValueError:
        pass


def test_decompress_rejects_hostile_continuation_bytes():
    """A run of 0xFF length-continuation bytes must be rejected, not wrap
    the accumulated length negative and copy out of bounds."""
    payload = bytes([0xF0]) + b"\xff" * (1 << 20) + b"\x00"
    blob = native.MAGIC + (64).to_bytes(4, "little") + payload
    with pytest.raises(ValueError):
        native.lz4_decompress(blob)
    lit = bytes([0x4F]) + b"abcd" + b"\x01\x00" + b"\xff" * (1 << 20) + b"\x00"
    blob2 = native.MAGIC + (64).to_bytes(4, "little") + lit
    with pytest.raises(ValueError):
        native.lz4_decompress(blob2)


def test_decompress_rejects_absurd_declared_size():
    blob = native.MAGIC + (0xFFFFFFFF).to_bytes(4, "little") + b"\x00" * 16
    with pytest.raises(ValueError):
        native.lz4_decompress(blob)


def test_decompress_fuzz_random_payloads(ref_codec):
    """Random and mutated payloads either decode or raise ValueError, and
    decode to what the reference's codec gives."""
    rng = random.Random(0)
    data = bytes(rng.randrange(4) for _ in range(4096))
    good = native.lz4_compress(data)
    assert native.lz4_decompress(good) == data
    blobs = []
    for _ in range(200):
        blob = bytearray(good)
        for _ in range(rng.randrange(1, 8)):
            blob[rng.randrange(8, len(blob))] = rng.randrange(256)
        blobs.append(bytes(blob))
    for _ in range(100):
        junk = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 512)))
        blobs.append(native.MAGIC + (256).to_bytes(4, "little") + junk)
    for blob in blobs:
        try:
            out = native.lz4_decompress(blob)
        except ValueError:
            with pytest.raises(ValueError):
                ref_codec.lz4_decompress(blob)
        else:
            assert out == ref_codec.lz4_decompress(blob)

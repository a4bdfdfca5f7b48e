"""K8b's launch plan (``taploop_conv``) and the host twins of its TMA
kernel's swizzle and schedule, held to the card's limits on the CPU.

``fl_tpu_torch.ops.conv_probe.taploop_launch_plan`` is a pure function of
the dtype and the shapes, so its route and what a launch would ask of an
H100 are checked without one: float32 always on the CUDA cores; bfloat16 on
the ``tma`` route exactly where I and O are multiples of 8, the halo'd image
is one TMA box and the ring of a power-of-two number of stages holds the
images of two tiles; at most 232,448 bytes of shared memory a block. The
twins are ``swizzle_span`` (where TMA's 32-, 64- and 128-byte swizzles put
a staged row's 16-byte pieces, as the kernel's ``ldmatrix`` addresses read
them) and ``taploop_walk`` (the producer's image stream and the two
consumer warpgroups' ring positions, walked apart as on the card). This
file imports no JAX and needs no GPU.
"""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fl_tpu_torch.ops import conv_probe as probe

SMEM_LIMIT = 232448      # bytes of shared memory one block may use
SMS = 132                # SMs of an H100 SXM

BENCH = (512, 32, 14, 14, 32, 64)   # (C, B, H, W, I, O): the bench's conv2
# tests/test_torch_kernels.py's PATCH_SHAPES, (B, H, W, I, O) with 3 clients
PATCH_SHAPES = [(2, 14, 14, 32, 64), (2, 8, 8, 16, 16), (1, 28, 28, 4, 8),
                (2, 14, 14, 4, 128), (3, 5, 7, 3, 6), (3, 5, 7, 20, 12),
                (2, 14, 14, 48, 40)]
# the card tests' cases at the edges of the TMA route's design
EDGE_CASES = {
    "tile_spans_two_images": (2, 3, 14, 14, 32, 64),
    "ragged_last_tile": (3, 3, 5, 7, 16, 8),
    "three_column_passes": (2, 2, 8, 8, 32, 136),
    "swizzle_128B": (2, 2, 14, 14, 64, 64),
    "two_boxes_a_pixel": (2, 2, 8, 8, 96, 32),
    "clients_change_inside_a_block": (8, 32, 14, 14, 32, 64),
    "ring_of_two_28x28_images": (4, 8, 28, 28, 32, 64),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(B, H, W):
    return -(-B * H * W // probe.TMA_ROWS)


def _check_plan(plan, dtype, C, B, H, W, I, O):
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.smem_bytes == probe.taploop_smem_bytes(
        plan.route, dtype, H, W, I, O, plan.band, plan.stages)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    tma = (dtype == torch.bfloat16 and I % 8 == 0 and O % 8 == 0
           and max(H, W) + 2 <= 256)
    if plan.route == "cuda_core":
        assert plan.instruction == "fma"
        assert plan.blocks == C * -(-B // plan.items_per_block)
        assert 1 <= plan.band <= H
        # TMA could address it only where its ring did not fit
        assert not tma or probe._tma_stages(H, W, I, O) < max(
            2, probe.taploop_span(B, H, W))
        return
    assert tma and plan.instruction == "wgmma"
    assert plan.threads == probe.TMA_THREADS
    assert plan.k_chunk in (16, 32, 64) and plan.k_pad % plan.k_chunk == 0
    assert I <= plan.k_pad < I + plan.k_chunk
    assert plan.passes * plan.n_pass >= O > (plan.passes - 1) * plan.n_pass
    assert plan.rows == probe.TMA_ROWS and plan.tiles == _tiles(B, H, W)
    # a power-of-two ring that holds what two tiles read
    assert plan.stages & (plan.stages - 1) == 0
    assert max(2, probe.taploop_span(B, H, W)) <= plan.stages <= (
        probe.MAX_STAGES)
    # a persistent grid of at most one block an SM, no block idle
    items = C * plan.passes * plan.tiles
    assert 1 <= plan.blocks <= SMS
    assert plan.blocks * plan.items_per_block >= items
    assert (plan.blocks - 1) * plan.items_per_block < items


def test_bench_plan_streams_halod_images_through_tma():
    """512 clients x 32 images of 14x14, 32 -> 64: 64-byte staged rows
    (one 32-channel box, the 64-byte swizzle), 49 tiles of 128 rows a
    client, a ring of eight 16 KB images, one block an SM."""
    plan = probe.taploop_launch_plan(torch.bfloat16, *BENCH)
    _check_plan(plan, torch.bfloat16, *BENCH)
    assert (plan.route, plan.k_chunk, plan.k_pad, plan.n_pass) == (
        "tma", 32, 32, 64)
    assert (plan.rows, plan.tiles, plan.stages, plan.blocks,
            plan.items_per_block) == (128, 49, 8, 132, 191)
    box = 16 * 16 * 32 * 2
    assert plan.smem_bytes == (1024 + 8 * box + 2 * 128 * 64 * 2
                               + 9 * 32 * 64 * 2 + 16 * 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PATCH_SHAPES + [BENCH[1:]], ids=str)
def test_route_follows_dtype_and_shape(dtype, shape):
    plan = probe.taploop_launch_plan(dtype, 3, *shape)
    _check_plan(plan, dtype, 3, *shape)
    B, H, W, I, O = shape
    want = ("tma" if dtype == torch.bfloat16 and I % 8 == 0 and O % 8 == 0
            else "cuda_core")
    assert plan.route == want


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_design_edges_take_the_tma_route(case):
    shape = EDGE_CASES[case]
    plan = probe.taploop_launch_plan(torch.bfloat16, *shape)
    _check_plan(plan, torch.bfloat16, *shape)
    assert plan.route == "tma"


def test_routes_and_counts_are_named():
    assert probe.TAPLOOP_ROUTES == ("tma", "cuda_core")
    assert sorted(probe.TAPLOOP_ROUTE_LAUNCHES) == ["cuda_core", "tma"]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        probe.taploop_launch_plan(torch.float16, *BENCH)


@settings(max_examples=200, deadline=None)
@given(C=st.integers(1, 600), B=st.integers(1, 40), H=st.integers(1, 40),
       W=st.integers(1, 40), I=st.integers(1, 160), O=st.integers(1, 200),
       bf16=st.booleans())
def test_plan_fits_the_card_over_a_sweep_of_shapes(C, B, H, W, I, O, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    try:
        plan = probe.taploop_launch_plan(dtype, C, B, H, W, I, O)
    except ValueError as e:
        # refused in words, never planned beyond the card
        assert "shared memory" in str(e)
        assert probe.taploop_smem_bytes("cuda_core", dtype, H, W, I, O, 1,
                                        1) > SMEM_LIMIT
        return
    _check_plan(plan, dtype, C, B, H, W, I, O)


@pytest.mark.parametrize("span", [32, 64, 128])
def test_swizzle_twin_is_a_bijection_on_a_stage(span):
    """Every 16-byte piece of a 1024-aligned stage lands on one piece, and
    only the piece's index within its row moves."""
    stage = 16 * 16 * span
    seen = set()
    for off in range(0, stage, 16):
        got = probe.swizzle_span(off, span)
        assert got // span == off // span and got % 16 == 0
        seen.add(got)
    assert seen == set(range(0, stage, 16))


@pytest.mark.parametrize("span", [32, 64, 128])
@pytest.mark.parametrize("chunk", range(4))
def test_swizzle_keeps_an_ldmatrix_in_eight_bank_groups(span, chunk):
    """The eight rows of one 8 x 8 matrix are eight consecutive staged
    pixels (a tap's offset moves them together) at the same 16-byte piece:
    under the swizzle they fall into eight different 16-byte bank groups,
    wherever they start."""
    chunk %= span // 16
    for start in range(64):
        groups = {probe.swizzle_span((start + r) * span + 16 * chunk, span)
                  // 16 % 8 for r in range(8)}
        assert len(groups) == 8


def _walk_all(plan, C, B, H, W):
    return [probe.taploop_walk(plan, C, B, H, W, blk)
            for blk in range(plan.blocks)]


@pytest.mark.parametrize("case", sorted(EDGE_CASES) + ["bench_16_clients"])
def test_schedule_twin_covers_every_tile_once_and_releases_in_order(case):
    C, B, H, W, I, O = (16, *BENCH[1:]) if case == "bench_16_clients" else (
        EDGE_CASES[case])
    plan = probe.taploop_launch_plan(torch.bfloat16, C, B, H, W, I, O)
    M, HW = B * H * W, H * W
    covered = []
    for loads, items, releases in _walk_all(plan, C, B, H, W):
        covered += [key for key, _, _ in items]
        for n, ((c, p, t), pos, reload) in enumerate(items):
            # the images of the tile, at the ring positions the producer
            # filled with them
            want = range(t * plan.rows // HW,
                         (min(M, (t + 1) * plan.rows) - 1) // HW + 1)
            assert [loads[u] for u in pos] == [(c, p, b) for b in want]
            assert reload == (n == 0 or t == 0)
            # the ring holds this tile's images and the next one's
            if n + 1 < len(items):
                assert items[n + 1][1][-1] - pos[0] < plan.stages
        # each warpgroup with a tile hands back every position once, in
        # order, and never one that its next tile reads (a block of one
        # tile leaves the second warpgroup idle: nothing waits for it)
        for cw, rel in enumerate(releases):
            if not rel:
                assert cw == 1 and len(items) == 1
                continue
            flat = [u for step in rel for u in step]
            assert flat == list(range(len(loads)))
            for k, step in enumerate(rel[:-1]):
                nxt = items[cw + 2 * (k + 1)][1]
                assert not step or step[-1] < nxt[0]
        assert len(releases[0]) + len(releases[1]) == len(items)
    want = [(c, p, t) for c in range(C) for p in range(plan.passes)
            for t in range(plan.tiles)]
    assert covered == want

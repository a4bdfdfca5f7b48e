"""The client axis sharded over GPUs: one ``torch.distributed`` rank a
shard.

The port of ``fl_tpu.core.mesh``. The reference's single controller puts
the stacked client axis on a 1-D device mesh and lets ``shard_map`` give
each device its block; here every rank is a process of its own (SPMD), so
a :class:`ClientMesh` is the process group, this rank's place in it, its
device, and its block of the C clients: rows ``[rank·CL, (rank+1)·CL)``
with CL = C / world_size. Every rank builds the same host state from the
same seed (participation masks, accountants, ledgers); each holds only
its own rows of the client-stacked tensors on its device, and every
cross-client quantity goes through the group (``fl_tpu_torch.parallel``).

:func:`make_mesh` joins a group the caller has initialized, or the one
that ``torchrun`` describes in ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
(``MASTER_ADDR`` / ``MASTER_PORT``), or, with none of them, a group of one
rank. NCCL on ``cuda:LOCAL_RANK`` by default, gloo when the caller asks
for ``device="cpu"``. NCCL refuses two ranks on one card: two processes
that share a card take gloo (``backend="gloo"``), which reduces CUDA
tensors too.

:func:`spawn` runs a function on N ranks of this host (the tests' and
``chip_smoke.py``'s launcher): ``torch.multiprocessing`` processes joined
through a ``file://`` store in a temporary directory, which needs no port,
so concurrent launches cannot collide.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from fl_tpu_torch.core.pytree import tree_map

CLIENT_AXIS = "clients"  # the mesh's one axis (the reference's name)

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """One rank's view of the 1-D client mesh."""

    group: Any              # the torch.distributed process group
    rank: int
    world_size: int
    device: torch.device    # this rank's device
    backend: str            # "nccl" | "gloo"

    def client_rows(self, num_clients: int) -> Tuple[int, int]:
        """This rank's global client rows [lo, hi): CL = C / world_size
        consecutive clients."""
        if num_clients % self.world_size:
            raise ValueError(
                f"num_clients={num_clients} must divide evenly over the "
                f"{self.world_size}-device mesh; pad the client count "
                "(fl_tpu_torch.core.mesh.pad_to_multiple) — surplus slots "
                "can be masked out of participation")
        cl = num_clients // self.world_size
        return self.rank * cl, (self.rank + 1) * cl


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              backend: Optional[str] = None) -> ClientMesh:
    """This rank's :class:`ClientMesh` over ``n_devices`` ranks (default:
    the whole group).

    Joins the initialized default group, or initializes it from
    ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` (``env://``), or as a group of
    one rank through a ``file://`` store. ``device="cuda"`` means
    ``cuda:LOCAL_RANK``; an indexed device (``"cuda:0"``) is taken as
    given, so that ranks may share a card. The backend defaults to NCCL on
    a card and gloo on the CPU; without a card and without
    ``device="cpu"`` this raises, as the engine does."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"make_mesh puts the ranks on device={str(device)!r} and no "
                "CUDA device is available; pass device=\"cpu\" (gloo) to "
                "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"device={str(device)!r}: expected 'cuda' or 'cpu'")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' reduces CUDA tensors only; use "
                         "gloo on the CPU")
    if not dist.is_initialized():
        rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
        kw = dict(backend=backend, timeout=TIMEOUT)
        if backend == "nccl":
            kw["device_id"] = dev
        if rank is not None and world is not None:
            dist.init_process_group(init_method="env://", rank=rank,
                                    world_size=world, **kw)
        else:
            store = tempfile.NamedTemporaryFile(prefix="fl_mesh_",
                                                delete=False)
            store.close()
            os.unlink(store.name)
            dist.init_process_group(init_method=f"file://{store.name}",
                                    rank=0, world_size=1, **kw)
    joined = dist.get_backend()
    if joined != backend:
        raise ValueError(f"the process group runs {joined!r}, not the "
                         f"requested backend={backend!r}")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"n_devices={n}: the process group has {world} "
                         "ranks, one a shard of the client axis")
    return ClientMesh(group=dist.group.WORLD, rank=dist.get_rank(),
                      world_size=world, device=dev, backend=backend)


def _same_device(device, mesh_device: torch.device) -> bool:
    """``device`` names the mesh's device ("cuda" for "cuda:1" too)."""
    d = torch.device(device)
    return d.type == mesh_device.type and d.index in (None,
                                                      mesh_device.index)


def resolve_device(owner: str, device, mesh) -> torch.device:
    """The device an engine runs on: the mesh's, which ``device`` may only
    name, or ``device``, the card by default. Without a card and without
    ``device="cpu"`` this raises."""
    if mesh is not None:
        if not isinstance(mesh, ClientMesh):
            raise ValueError(
                f"mesh must be a ClientMesh (fl_tpu_torch.core.mesh."
                f"make_mesh), got {type(mesh).__name__}")
        if device is not None and not _same_device(device, mesh.device):
            raise ValueError(
                f"device={str(device)!r} conflicts with the mesh's "
                f"device {str(mesh.device)!r}; with a mesh the engine "
                "runs on the mesh's device")
        device = mesh.device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner} runs on device={str(device)!r} and no CUDA device is "
            "available; pass device=\"cpu\" to run on the CPU")
    return device


def shard_client_tree(tree, mesh: ClientMesh):
    """This rank's rows of every (C, ...) leaf (numpy or tensors), copied
    to its device."""
    def shard(x):
        t = torch.as_tensor(x)
        lo, hi = mesh.client_rows(t.shape[0])
        return t[lo:hi].to(mesh.device).contiguous()

    return tree_map(shard, tree)


def replicate_tree(tree, mesh: ClientMesh):
    """Every leaf on this rank's device, equal to rank 0's (a broadcast
    from rank 0)."""
    def rep(x):
        t = torch.as_tensor(x).to(mesh.device).contiguous().clone()
        dist.broadcast(t, src=0, group=mesh.group)
        return t

    return tree_map(rep, tree)


def pad_to_multiple(n: int, m: int) -> int:
    """Round ``n`` up to a multiple of ``m`` (client counts must divide evenly
    over mesh devices; surplus slots are masked out of the aggregation)."""
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _rank_entry(rank: int, fn: Callable, world_size: int, store: str,
                out_dir: str, backend: str, device: str, args: tuple
                ) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # ranks share the host's cores
    elif device == "cuda":
        device = f"cuda:{rank}"  # one card a rank
    dist.init_process_group(backend=backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    try:
        result = fn(make_mesh(world_size, device=device, backend=backend),
                    *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, backend: str = "gloo",
          device: str = "cpu") -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` fresh processes of this
    host, one rank each, joined over ``backend`` with each rank on
    ``device`` (``"cuda:0"`` puts every rank on the first card), and return
    each rank's result (picklable; tensors on the CPU) in rank order.
    ``fn`` must be importable by name. A rank that raises fails the
    launch, and the other ranks are stopped."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="fl_spawn_") as tmp:
        store = os.path.join(tmp, "store")
        mp.spawn(_rank_entry, nprocs=world_size, join=True,
                 args=(fn, world_size, store, tmp, backend, device, args))
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out

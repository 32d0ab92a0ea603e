"""Process-per-device launch (counterpart of the JAX package's `launch`,
cddmsl_tpu/engine/defaults.py, with the reference's meaning of
`--num-gpus`: one process per GPU).

`launch(main, num_gpus_per_machine, num_machines, machine_rank, dist_url)`
runs `main(*args)` in each of the world's processes: it spawns
`num_gpus_per_machine` processes on this machine (global rank =
machine_rank * num_gpus_per_machine + local rank), each joins the process
group (`parallel/comm.py initialize`) and runs `main`. With one process in
all and no `dist_url` it calls `main` here, without a process group. With
one process per machine, or a `dist_url` given for a world of one, this
process joins the group itself.

NCCL on the card, one card per local rank; gloo with `device="cpu"`
(`--device cpu --num-gpus N` runs N CPU processes). `backend="gloo"` on the
card lets local ranks share the cards there are (rank r on cuda:(r mod
cards)), through the host.
"""

import os
import socket
from typing import Callable, Optional

import torch

from ..parallel import comm


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(local_rank: int, main_func: Callable, world_size: int, num_gpus_per_machine: int, machine_rank: int,
            backend: str, dist_url: str, device: str, args: tuple):
    rank = machine_rank * num_gpus_per_machine + local_rank
    if torch.device(device).type == "cpu":  # OMP_NUM_THREADS, or the machine's cores shared out over the ranks
        threads = int(os.environ.get("OMP_NUM_THREADS", "0")) or len(os.sched_getaffinity(0)) // num_gpus_per_machine
        torch.set_num_threads(max(1, threads))
    comm.initialize(backend, dist_url, world_size, rank, local_rank, device)
    try:
        comm.synchronize()
        return main_func(*args)
    finally:
        comm.destroy()


def launch(main_func: Callable, num_gpus_per_machine: int = 1, num_machines: int = 1, machine_rank: int = 0,
           dist_url: Optional[str] = "auto", device: str = "cuda", backend: Optional[str] = None, args: tuple = ()):
    """Runs `main_func(*args)` on every process of a world of
    num_gpus_per_machine * num_machines; returns its result where it runs
    here (one local process), else None once the spawned ones have ended
    (an error in one of them raises here). `dist_url` is the rendezvous,
    "tcp://host:port" or "file://path"; "auto" picks a free local port on
    one machine."""
    if num_gpus_per_machine < 1 or num_machines < 1:
        raise ValueError(f"--num-gpus {num_gpus_per_machine} and --num-machines {num_machines} must be positive")
    if not 0 <= machine_rank < num_machines:
        raise ValueError(f"--machine-rank {machine_rank} is not in [0, {num_machines})")
    world = num_gpus_per_machine * num_machines
    auto = dist_url in (None, "", "auto")
    if world == 1 and auto:
        return main_func(*args)
    if auto:
        if num_machines > 1:
            raise ValueError("--dist-url tcp://host:port is needed for more than one machine")
        dist_url = f"tcp://127.0.0.1:{_free_port()}"
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    worker_args = (main_func, world, num_gpus_per_machine, machine_rank, backend, dist_url, device, args)
    if num_gpus_per_machine == 1:
        return _worker(0, *worker_args)
    torch.multiprocessing.spawn(_worker, nprocs=num_gpus_per_machine, args=worker_args, join=True)
    return None

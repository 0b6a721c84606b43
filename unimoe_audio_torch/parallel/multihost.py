"""Multi-process start-up shared by the serve and training CLIs —
counterpart of `unimoe_audio_tpu/parallel/multihost.py`: one
`torch.distributed.init_process_group` call in place of
`jax.distributed.initialize()`, either from the `torchrun` environment
(bare `--multihost`: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or
explicit (`--coordinator-address HOST:PORT --num-processes N --process-id
I`).  NCCL on the card (each process on card LOCAL_RANK, or its process id
modulo the cards), gloo on the CPU.
"""

from __future__ import annotations

import argparse
import os


def add_multihost_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("multi-process (torch.distributed)")
    g.add_argument("--multihost", action="store_true",
                   help="start the process group from the torchrun environment")
    g.add_argument("--coordinator-address", default=None, metavar="HOST:PORT",
                   help="rank 0's address (implies --multihost)")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)


def init_process_group(*, coordinator_address=None, num_processes=None, process_id=None,
                       cpu: bool = False) -> None:
    """torch.distributed over tcp://coordinator_address with the given world
    size and rank, or over the torchrun environment (env://)."""
    import torch
    import torch.distributed as dist

    backend = "gloo" if cpu else "nccl"
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator-address needs --num-processes and --process-id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    if not cpu:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def maybe_initialize_multihost(args, *, initialize=None, cpu: bool = False) -> bool:
    """Start the process group per the parsed args; True when it started.
    `initialize` is injectable for tests (default `init_process_group`,
    given `cpu`); it receives the JAX package's keyword names."""
    if not (args.multihost or args.coordinator_address):
        return False
    kwargs = {}
    if args.coordinator_address:
        kwargs["coordinator_address"] = args.coordinator_address
    if args.num_processes is not None:
        kwargs["num_processes"] = args.num_processes
    if args.process_id is not None:
        kwargs["process_id"] = args.process_id
    if initialize is None:
        init_process_group(cpu=cpu, **kwargs)
    else:
        initialize(**kwargs)
    return True

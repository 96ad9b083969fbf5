"""Runs a rank body of the port's parallel tests in N processes, one a rank,
over gloo on the CPU.

The parent (a test module, through ``start_ranks``) writes the inputs into a
work directory, starts ``python tests/_ranks.py <module> <body> <rank>
<world> <port> <workdir>`` once per rank with a hard timeout, goes on with
its own work, and reads back what each rank saved when it first reads a
result. A rank imports torch, numpy, the port and its body's
module (``tests/_ranks_*.py``), never JAX or ``tests/conftest.py``.
"""

import importlib
import os
import pickle
import socket
import subprocess
import sys
import time
import weakref
from collections.abc import Sequence
from pathlib import Path

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
RANK_TIMEOUT = 120


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def save(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


class Ranks(Sequence):
    """The results of a group of rank processes (``start_ranks``), one per
    rank: reading one waits for the group, then fails with the ranks'
    output if one failed or the group outlived its timeout."""

    def __init__(self, module, body, procs, logs, workdir, deadline):
        self.module, self.body, self.procs, self.logs = module, body, procs, logs
        self.workdir, self.deadline, self._results = workdir, deadline, None
        weakref.finalize(self, _kill, procs)

    def __len__(self):
        return len(self.procs)

    def __getitem__(self, i):
        return self.results()[i]

    def results(self):
        if self._results is None:
            self._results = self._wait()
        return self._results

    def _wait(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            _kill(self.procs)
        outputs = []
        for f in self.logs:
            f.seek(0)
            outputs.append(f.read())
            f.close()
        codes = [p.returncode for p in self.procs]
        if any(codes):
            raise AssertionError(f"{self.module}.{self.body} on {len(self)} ranks: exit codes "
                                 f"{codes}\n" + "\n".join(f"--- rank {r}\n{o[-4000:]}"
                                                            for r, o in enumerate(outputs)))
        return [load(self.workdir / f"{self.body}_rank{r}.pkl") for r in range(len(self))]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def start_ranks(module, body, world, workdir, inputs, timeout=RANK_TIMEOUT, torchrun=False):
    """Start ``module.body(rank, world, workdir, inputs)`` on ``world`` gloo
    ranks and return their ``Ranks`` at once, so that the caller's own work
    overlaps theirs; the group has ``timeout`` seconds from now. With
    ``torchrun`` the ranks get torchrun's variables instead of a group, and
    the body starts the group itself."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    save(workdir / "inputs.pkl", inputs)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(world)]
    procs = []
    for r in range(world):
        if torchrun:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, str(TESTS / "_ranks.py"), module, body, str(r), str(world),
             str(port), str(workdir)],
            cwd=str(ROOT), env=env, stdout=logs[r], stderr=subprocess.STDOUT))
    return Ranks(module, body, procs, logs, workdir, time.monotonic() + timeout)


def _child(module, body, rank, world, port, workdir):
    import torch
    import torch.distributed as dist

    sys.modules["torch.utils.tensorboard"] = None  # no writers: they import TensorFlow
    torch.set_num_threads(1)
    if "RANK" not in os.environ:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
    try:
        fn = getattr(importlib.import_module(module), body)
        result = fn(rank, world, Path(workdir), load(Path(workdir) / "inputs.pkl"))
        save(Path(workdir) / f"{body}_rank{rank}.pkl", result)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(TESTS)]
    name, fn_name, r, n, p, wd = sys.argv[1:7]
    _child(name, fn_name, int(r), int(n), int(p), wd)


def flat(tree, prefix=()):
    """{path: numpy array} of a nest of dicts (flax variables, either
    package's)."""
    import numpy as np

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, dtype=np.float32)
    return out


def assert_close(got, want, rtol, atol):
    """Two nests of arrays with the same leaves, leaf by leaf."""
    import numpy as np

    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)

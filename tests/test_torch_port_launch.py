"""The rank launcher's ranks started ahead of their call, and checkpoint
saves without zip CRC-32s, on the CPU.

- `parallel/launch.py::Ranks(None, ...)`: the ranks import, bring their
  gloo group up and wait; `call` hands them a rank function, whose results
  come back as from ranks started with it. Ranks never given a call are
  refused (and killed) by `results`, and a waiting rank whose parent has
  gone exits without a call.
- `train/trainer.py::save_without_crc32`: the file loads back bit for bit
  with `torch.load`, its zip records carry no CRC-32, and torch's own
  setting is left as it was.
"""

import os
import signal
import subprocess
import sys
import time
import zipfile

import pytest
import torch

from evoworld_tpu_torch.parallel.launch import Ranks
from evoworld_tpu_torch.train.trainer import save_without_crc32
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_started_ahead_run_their_call(tmp_path, world):
    """Ranks started with no target wait until `call`, then run it on the
    mesh they brought up; the result is what ranks started with the same
    call return."""
    ahead = Ranks(None, world, str(tmp_path / "ahead"), device="cpu")
    assert not any(p.poll() is not None for p in ahead.procs)  # waiting, not ended
    got = ahead.call("evoworld_tpu_torch.parallel.checks:several_rank", ([],), timeout=120).results()
    want = Ranks("evoworld_tpu_torch.parallel.checks:several_rank", world, str(tmp_path / "direct"), device="cpu",
                 args=([],), timeout=120).results()
    assert got == want == [[]] * world
    with pytest.raises(RuntimeError, match="already have their call"):
        ahead.call("evoworld_tpu_torch.parallel.checks:several_rank", ([],))


def test_ranks_never_called_are_refused_and_killed(tmp_path):
    ahead = Ranks(None, 2, str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="never given their call"):
        ahead.results()
    assert all(p.poll() is not None for p in ahead.procs)


def test_waiting_ranks_end_when_their_parent_ends(tmp_path):
    """A parent that starts ranks ahead and exits without calling them
    leaves no rank behind: each sees its parent gone and exits."""
    script = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from evoworld_tpu_torch.parallel.launch import Ranks; "
              "r = Ranks(None, 2, sys.argv[2], device='cpu'); print(*[p.pid for p in r.procs])")
    out = subprocess.run([sys.executable, "-c", script, ROOT, str(tmp_path)], capture_output=True, text=True,
                         check=True, timeout=60).stdout.split()
    pids = [int(p) for p in out]
    deadline = time.monotonic() + 60
    try:
        while time.monotonic() < deadline and any(_alive(p) for p in pids):
            time.sleep(0.1)
        assert not any(_alive(p) for p in pids)
    finally:
        for p in pids:  # a rank left waiting by a failure here is ended
            if _alive(p):
                os.kill(p, signal.SIGKILL)


def _alive(pid: int) -> bool:
    """Whether `pid` runs (a zombie awaiting its reaper does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_save_without_crc32_loads_back_and_keeps_the_setting(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn((64, 33), generator=g), "b": torch.randn(7, generator=g).to(torch.bfloat16)},
             "step": 3}
    before = torch.serialization.get_crc32_options()
    path = str(tmp_path / "ckpt.pt")
    save_without_crc32(state, path)
    assert torch.serialization.get_crc32_options() == before
    back = torch.load(path, weights_only=True)
    assert back["step"] == 3 and set(back["params"]) == {"w", "b"}
    assert all(torch.equal(back["params"][k], state["params"][k]) for k in state["params"])
    with zipfile.ZipFile(path) as z:
        data = [i for i in z.infolist() if "/data/" in i.filename]
        assert data and all(i.CRC == 0 for i in data)

"""The port's crash supervisor (simplesr_tpu_torch/tools/supervise.py), with
the JAX package's four cases (restart on a crash with ``--resume``, stop on
the preemption code, an exhausted restart budget, the ``--cmd`` hook), and
one run end to end: the production recipe (``paired_train: 2`` as written),
cut for the CPU, trained by ``tools.train --device cpu`` in a child that
SIGKILLs itself once after its first epoch and finishes under the
supervisor from its resume point, its TensorBoard scalars written through
the port's own event writer."""

import json
import sys
from pathlib import Path

import pytest

from simplesr_tpu.tools import supervise as jax_supervise
from simplesr_tpu_torch.config import _yaml
from simplesr_tpu_torch.data.png import read_png, write_png
from simplesr_tpu_torch.tools import supervise
from simplesr_tpu_torch.utils.tensorboard import event_files, read_scalars

ROOT = Path(__file__).resolve().parents[1]
GALLERY = str(ROOT / "data/corpus/gallery")
PRODUCTION = ROOT / "examples/training/srresnet_x4_paired_production.yaml"
CORPUS_IMAGES = 8  # 24 x 24 crops of gallery PNGs: the Python PNG decode stays quick


def test_restarts_a_crash_with_resume(tmp_path):
    # the child crashes until the marker exists, then succeeds, and must see
    # --resume on every restart
    marker = tmp_path / "crashed_once"
    child = tmp_path / "child.py"
    child.write_text(f"""
import os, sys
marker = {str(marker)!r}
if not os.path.exists(marker):
    open(marker, "w").close()
    sys.exit(1)          # first run: crash
sys.exit(0 if "--resume" in sys.argv else 2)
""")
    calls = []
    rc = supervise.supervise([sys.executable, str(child)], max_restarts=3, backoff=0.0,
                             log=calls.append)
    assert rc == 0 and marker.exists()
    assert calls[-1] == "[supervise] training complete"
    assert calls[2].endswith(f"{child} --resume")


@pytest.mark.parametrize("lib", [supervise, jax_supervise], ids=["port", "jax"])
def test_stops_on_the_preemption_code(tmp_path, lib):
    child = tmp_path / "child.py"
    child.write_text("import sys; sys.exit(75)")
    calls = []
    rc = lib.supervise([sys.executable, str(child)], max_restarts=3, backoff=0.0,
                       log=calls.append)
    assert rc == 75  # a resumable stop: not restarted in place
    assert any("not restarting" in m for m in calls)
    assert len(calls) == 2


def test_exhausts_the_restart_budget(tmp_path):
    child = tmp_path / "child.py"
    child.write_text("import sys; sys.exit(3)")
    logs = {}
    for name, lib in (("port", supervise), ("jax", jax_supervise)):
        logs[name] = []
        rc = lib.supervise([sys.executable, str(child)], max_restarts=2, backoff=0.0,
                           log=logs[name].append)
        assert rc == 3
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 6


def test_cli_cmd_hook_and_arguments(tmp_path):
    child = tmp_path / "ok.py"
    child.write_text("import sys; sys.exit(0)")
    assert supervise.main(["--max-restarts", "1", "--cmd", sys.executable, str(child)]) == 0
    for argv in (["--max-restarts", "-1", "x.yaml"], ["--backoff", "-1", "x.yaml"], []):
        with pytest.raises(SystemExit):
            supervise.main(argv)


def test_device_is_passed_to_the_child(monkeypatch):
    seen = []
    monkeypatch.setattr(supervise, "supervise", lambda cmd, **kw: seen.append(cmd) or 0)
    assert supervise.main(["run.yaml", "--device", "cpu"]) == 0
    assert seen == [[sys.executable, "-m", "simplesr_tpu_torch.tools.train", "run.yaml",
                     "--device", "cpu"]]


def test_end_to_end_crash_resume(tmp_path):
    """tools.train --device cpu on 8 small gallery crops, SIGKILLed (no
    SIGTERM grace) once the first epoch's resume point says so, restarted
    with --resume, and finished at the second epoch in the same run
    directory."""
    spec = _yaml.load(PRODUCTION)
    assert spec["general"]["paired_train"] == 2
    results, corpus = tmp_path / "results", tmp_path / "corpus"
    corpus.mkdir()
    for i, path in enumerate(sorted(Path(GALLERY).glob("*.png"))[:CORPUS_IMAGES]):
        write_png(corpus / path.name, read_png(path)[i:i + 24, i:i + 24])
    spec["general"].update(train_data_paths=str(corpus), results_save_path=str(results),
                           num_epochs=2, crop_size=(16, 16, 3), num_crops=1, random_seed=0)
    spec["model"]["generator"].update(num_blocks=1, num_filters=8, dtype="float32")
    cfg = tmp_path / "run.yaml"
    cfg.write_text(_yaml.dump(spec))
    marker = tmp_path / "killed_once"
    wrapper = tmp_path / "flaky_train.py"
    wrapper.write_text(f"""
import glob, json, os, signal, sys, threading, time
sys.path.insert(0, {str(ROOT)!r})
marker = {str(marker)!r}
if not os.path.exists(marker):
    def killer():
        while True:
            for p in glob.glob({str(results / "training")!r}
                               + "/*/checkpoints/resnet_resume_meta.json"):
                try:
                    if json.load(open(p))["completed_epochs"] >= 1:
                        open(marker, "w").close()
                        os.kill(os.getpid(), signal.SIGKILL)
                except (OSError, ValueError, KeyError):
                    pass
            time.sleep(0.05)
    threading.Thread(target=killer, daemon=True).start()
from simplesr_tpu_torch.tools.train import main
sys.exit(main([{str(cfg)!r}, "--device", "cpu"] + sys.argv[1:]))
""")
    calls = []
    rc = supervise.supervise([sys.executable, str(wrapper)], max_restarts=2, backoff=0.0,
                             log=calls.append)
    assert rc == 0 and marker.exists()  # the kill really happened
    assert calls[1].startswith("[supervise] child crashed (rc=-9)")
    assert calls[2].endswith("--resume")
    runs = [r for r in (results / "training").iterdir() if not r.is_symlink()]
    assert len(runs) == 1
    meta = json.loads((runs[0] / "checkpoints" / "resnet_resume_meta.json").read_text())
    assert meta["completed_epochs"] == 2
    assert len(meta["train_epoch_history"]["generator_loss"]) == 2
    assert (runs[0] / "models" / "resnet_gen_best.msgpack").exists()
    # TensorBoard: one events file a process, the epoch scalars of every epoch once
    for d in ("train/epoch", "val/epoch"):
        logs = runs[0] / "logs" / d
        assert len(event_files(logs)) == 2, d
        scalars = read_scalars(logs)
        assert scalars and all(sorted(s for s, _ in v) == [1, 2] for v in scalars.values()), d

"""Model zoo, as simplesr_tpu.zoo: the trained campaign models committed
under ``results/`` as a registry. Every ``results/<campaign>/models/
*.msgpack`` is indexed with its recipe, scale and held-out metrics (from the
campaign's RESULTS*.json), and loads into a predictor in one call:

    from simplesr_tpu_torch import zoo
    zoo.list_models()                  # -> [ZooEntry, ...]
    predict = zoo.load("srresnet_x2")  # [0, 1] LR -> [-1, 1] SR, on the card
    module = zoo.load_raw("rrdb_x4")

Names are ``<recipe>_x<scale>`` (e.g. ``esrgan_lp_x2``). When two campaigns
ship the same recipe and scale, the unqualified name resolves to the
lexically latest campaign and every copy stays reachable as
``<name>@<campaign>`` (e.g. ``rrdb_x4@quality_r2_x4_deep``). ``zoo:<name>``
works wherever a model path does (``train.serialization.load_payload``).

``python -m simplesr_tpu_torch.zoo`` prints the registry as a table.
"""

import json
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

_FNAME_RE = re.compile(
    r"^(?P<kind>resnet|gan)_gen_(?P<recipe>.+)_x(?P<scale>\d+)"
    r"_(?P<tag>best_ema|best|final)\.msgpack$")


@dataclass
class ZooEntry:
    name: str            # unqualified <recipe>_x<scale>
    qualified: str       # <name>@<campaign> — always unambiguous
    path: str
    kind: str            # resnet | gan (training mode, not architecture)
    recipe: str
    scale: int
    tag: str             # best | final | best_ema
    campaign: str        # source results subdir
    metrics: dict = field(default_factory=dict)  # held-out averages

    def summary(self):
        m = self.metrics
        met = ""
        if "heldout_psnr" in m:
            met = (f"held-out {m['heldout_psnr']:.2f} dB "
                   f"(bicubic {m['heldout_psnr_bicubic']:.2f})")
            if "heldout_lp" in m:
                met += f" lp {m['heldout_lp']:.4f}"
        return (f"{self.name:<22} x{self.scale} {self.kind:<7} "
                f"{self.campaign:<22} {met}")


def _results_root(root=None):
    if root is not None:
        return Path(root)
    return Path(__file__).resolve().parent.parent / "results"


def _heldout_metrics(results_dir, recipe):
    """Average the held-out rows for ``recipe`` across the campaign's
    RESULTS*.json files (schema: scripts/quality_campaign.py)."""
    for fname in sorted(os.listdir(results_dir)):
        if not (fname.startswith("RESULTS") and fname.endswith(".json")):
            continue
        try:
            with open(results_dir / fname) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        per_img = data.get(recipe)
        if not isinstance(per_img, dict):
            continue
        # the model column is "model" in RESULTS.json, "noise_trained" in
        # the JPEG-degradation study (RESULTS_jpg.json)
        col = "model" if any("model" in v for v in per_img.values()
                             if isinstance(v, dict)) else "noise_trained"
        rows = [v for v in per_img.values()
                if isinstance(v, dict) and v.get("heldout")
                and col in v and "bicubic" in v]
        if not rows:
            continue
        n = len(rows)
        out = {
            "heldout_psnr": sum(r[col]["psnr"] for r in rows) / n,
            "heldout_ssim": sum(r[col]["ssim"] for r in rows) / n,
            "heldout_psnr_bicubic":
                sum(r["bicubic"]["psnr"] for r in rows) / n,
            "heldout_images": n,
        }
        if all("lp" in r[col] for r in rows):
            # learned-perceptual feature distance (campaign-local extractor;
            # comparable only within one campaign — docs/zoo.md)
            out["heldout_lp"] = sum(r[col]["lp"] for r in rows) / n
            out["heldout_lp_bicubic"] = \
                sum(r["bicubic"]["lp"] for r in rows) / n
        if col == "noise_trained":  # scored on JPEG-degraded inputs
            out["degraded_inputs"] = True
        return out
        # fallthrough below handles the round-4 jpg-study schema
    for fname in sorted(os.listdir(results_dir)):
        if not (fname.startswith("RESULTS") and fname.endswith(".json")):
            continue
        try:
            with open(results_dir / fname) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        got = _jpg_study_metrics(data, recipe)
        if got:
            return got
    return {}


def _jpg_study_metrics(data, recipe):
    """Round-4 JPEG-study schema: ``images.<name>.<quality>.<column>``
    (scripts/jpg_noise_study.py). The noise-trained recipe is scored on the
    degraded qualities (its domain); the clean control on clean inputs."""
    images = data.get("images")
    if not isinstance(images, dict):
        return {}
    if "jpg" in recipe:
        col, qualities, degraded = "noise_trained", None, True
    elif "ctl" in recipe or "control" in recipe:
        col, qualities, degraded = "clean_control", ("clean",), False
    else:
        return {}
    psnr, ssim, bic, names = [], [], [], set()
    for name, per_img in images.items():
        if not (isinstance(per_img, dict) and per_img.get("heldout")):
            continue
        for q, row in per_img.items():
            if q == "heldout" or not isinstance(row, dict):
                continue
            if qualities is None and q == "clean":
                continue  # degraded-domain metric excludes clean inputs
            if qualities is not None and q not in qualities:
                continue
            if col in row and "bicubic" in row:
                psnr.append(row[col]["psnr"])
                ssim.append(row[col]["ssim"])
                bic.append(row["bicubic"]["psnr"])
                names.add(name)
    if not psnr:
        return {}
    n = len(psnr)
    out = {
        "heldout_psnr": round(sum(psnr) / n, 4),
        "heldout_ssim": round(sum(ssim) / n, 4),
        "heldout_psnr_bicubic": round(sum(bic) / n, 4),
        "heldout_images": len(names),
    }
    if degraded:
        out["degraded_inputs"] = True
    return out


def list_models(root=None):
    """Scan ``results/*/models/*.msgpack`` → sorted [ZooEntry]. Unqualified
    names are unique: on recipe/scale collisions the lexically-latest
    campaign keeps the short name, the rest carry their qualified name."""
    base = _results_root(root)
    entries = []
    if not base.is_dir():
        return entries
    for campaign_dir in sorted(p for p in base.iterdir() if p.is_dir()):
        models_dir = campaign_dir / "models"
        if not models_dir.is_dir():
            continue
        for f in sorted(models_dir.glob("*.msgpack")):
            m = _FNAME_RE.match(f.name)
            if not m:
                continue
            recipe, scale = m["recipe"], int(m["scale"])
            name = f"{recipe}_x{scale}"
            entries.append(ZooEntry(
                name=name,
                qualified=f"{name}@{campaign_dir.name}",
                path=str(f), kind=m["kind"], recipe=recipe, scale=scale,
                tag=m["tag"], campaign=campaign_dir.name,
                metrics=_heldout_metrics(campaign_dir, recipe)))
    # collision resolution: latest campaign (lexical) keeps the short name
    by_name = {}
    for e in entries:
        prev = by_name.get(e.name)
        if prev is None or e.campaign > prev.campaign:
            by_name[e.name] = e
    for e in entries:
        if by_name[e.name] is not e:
            e.name = e.qualified
    return entries


def describe(name, root=None) -> Optional[ZooEntry]:
    """Look up one entry by unqualified or qualified name."""
    for e in list_models(root):
        if name in (e.name, e.qualified):
            return e
    return None


def resolve(name, root=None):
    """The entry of ``name`` (unqualified or qualified); KeyError listing
    the names when there is none."""
    entry = describe(name, root)
    if entry is None:
        known = ", ".join(sorted(e.name for e in list_models(root)))
        raise KeyError(f"unknown zoo model {name!r}; available: {known}")
    return entry


def load_raw(name, root=None, device="cuda"):
    """Zoo name -> the generator with its weights, in eval mode, on
    ``device`` (train/serialization.py)."""
    from simplesr_tpu_torch.train import serialization
    return serialization.load_model(resolve(name, root).path, device=device)


def load(name, root=None, fast=True, ensemble=False, paired=0, device="cuda"):
    """Zoo name -> predictor ([0, 1] LR batch NHWC -> [-1, 1] SR batch) on
    ``device``. The options are tools/upscale.py's: ``fast`` the exact
    polyphase tail where one exists, ``ensemble`` the x8 geometric
    self-ensemble, ``paired`` the paired trunk's width."""
    from simplesr_tpu_torch.eval.evaluation import _as_predictor
    return _as_predictor(resolve(name, root).path, fast=fast, ensemble=ensemble,
                         paired=paired, device=device)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="The model zoo: committed campaign models")
    p.add_argument("--root", default=None,
                   help="results root (default: the repo's results/)")
    args = p.parse_args(argv)
    entries = list_models(args.root)
    if not entries:
        print("no zoo models found")
        return 1
    for e in sorted(entries, key=lambda e: (e.scale, e.name)):
        print(e.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

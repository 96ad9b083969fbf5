"""Larger sweeps of the port's image decoders against PIL 12.1 than the
tests run, over the texture and icon fixtures (data/corpus/texture_formats):

    python tests/_fuzz_formats.py decode SEED COPIES   # damaged copies of each fixture
    python tests/_fuzz_formats.py kind SEED HEADERS    # seeded headers, dispatch only

``decode``: each fixture cut short or with bytes flipped (the header's
first 200 bytes more often), ``COPIES`` times, decoded by the port
(``decode_image``) and by PIL (``convert("RGB")``) in this process under a
6 GiB address-space cap, so a runaway allocation fails here, not the
machine. Every copy the port decodes must equal PIL's decode; a copy that
differs, or that PIL refuses, is written beside the script's output
directory (``--out``, default a temporary one) for a look.

``kind``: headers that start with a magic of the formats near TGA in
``Image.ID`` (ICO, CUR, PCX, DCX, DDS, QOI, SGI, MPEG, TGA types), then
seeded bytes, mostly small values so that header tests pass; wherever PIL
opens one, ``image_kind`` must name PIL's format.

Prints one JSON line of counts.
"""

import argparse
import hashlib
import io
import json
import resource
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from simplesr_tpu_torch.data.image import decode_image, image_kind  # noqa: E402

CORPUS = ROOT / "data/corpus/texture_formats"
PREFIXES = [b"\0\0\1\0", b"\0\0\2\0", b"\x0a\x05", b"\x0a\x00", b"\xb1\x68\xde\x3a", b"DDS ",
            b"qoif", b"\x01\xda", b"\0\0\1\xb3", b"", b"\0\0\2", b"\0\0\x0a", b"\0\1\1",
            b"\0\0\3", b"\0\0\x0b"]


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def _damaged(data, rng, k):
    if k % 4 == 0:
        return data[:int(rng.integers(1, len(data)))]
    d = bytearray(data)
    for _ in range(int(rng.integers(1, 5))):
        i = int(rng.integers(0, min(len(d), 200) if k % 4 == 1 else len(d)))
        d[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 else d[i] ^ (1 << int(rng.integers(0, 8)))
    return bytes(d)


def sweep_decode(rng, copies, out):
    counts = {"both": 0, "refused": 0, "port_only": 0, "differ": 0}
    for path in sorted(p for p in CORPUS.iterdir() if p.suffix != ".json"):
        data = path.read_bytes()
        for k in range(copies):
            v = _damaged(data, rng, k)
            try:
                port = _digest(decode_image(v))
            except ValueError:
                counts["refused"] += 1
                continue
            try:
                pil = _digest(np.asarray(Image.open(io.BytesIO(v)).convert("RGB")))
            except Exception:  # PIL's refusals take many types
                pil = None
            kind = "both" if port == pil else "port_only" if pil is None else "differ"
            counts[kind] += 1
            if kind != "both":
                (out / f"{kind}_{path.name}_{k}").write_bytes(v)
    return counts


def sweep_kind(rng, headers):
    counts = {"pil_opens": 0, "differ": 0}
    for t in range(headers):
        body = rng.integers(0, 256, int(rng.integers(0, 200)), dtype=np.uint8)
        if rng.random() < 0.5:
            body = body % 4 * rng.integers(0, 2, body.size, dtype=np.uint8)
        data = PREFIXES[t % len(PREFIXES)] + body.tobytes()
        try:
            fmt = Image.open(io.BytesIO(data)).format
        except Exception:
            continue
        counts["pil_opens"] += 1
        counts["differ"] += image_kind(data) != {"PPM": "pnm"}.get(fmt, fmt.lower())
    return counts


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("decode", "kind"))
    p.add_argument("seed", type=int)
    p.add_argument("count", type=int)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    resource.setrlimit(resource.RLIMIT_AS, (6 << 30, 6 << 30))
    warnings.simplefilter("ignore")
    rng = np.random.default_rng(args.seed)
    if args.what == "decode":
        out = Path(args.out or tempfile.mkdtemp(prefix="fuzz_formats_"))
        out.mkdir(parents=True, exist_ok=True)
        counts = sweep_decode(rng, args.count, out)
    else:
        counts = sweep_kind(rng, args.count)
    print(json.dumps({"what": args.what, "seed": args.seed, "count": args.count, **counts}))


if __name__ == "__main__":
    main()

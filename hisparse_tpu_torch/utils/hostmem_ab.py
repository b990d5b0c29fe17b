"""Time googleplus's pack with the host allocator untuned and tuned
(``utils/hostmem.tune_allocator``), each in a fresh process.

    python -m hisparse_tpu_torch.utils.hostmem_ab

Makes ``chip_smoke.py``'s googleplus matrix, writes it to an npz in a
temporary directory, and packs it at ``chip_smoke.py``'s point (phase 4)
in 21 fresh processes: one warm-up, whose time is dropped, then 10
pairs whose first side alternates (untuned first in even pairs, tuned
first in odd ones), so that neither side always runs first.
Each process tunes the allocator or not, loads the matrix and times the
pack alone; all of them must pack the same tiles.  Prints one line a
pair; the means; the mean and standard error of the paired differences
(untuned - tuned); the pairs the tuned pack won; and the verdict: tuned
faster if the mean difference exceeds twice its standard error, slower
if it is below minus twice it, else unresolved.  The last line is one
JSON object of these numbers.  The packs run on the host: the result
speaks for the host it runs on, so run it on the card's.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

from ..formats.csr import powerlaw_csr, save_npz
from .bench import GOOGLEPLUS, GOOGLEPLUS_CFG, GOOGLEPLUS_PACK

# a fresh process: tune the allocator or not, load the matrix, time the
# pack; prints the seconds and the tiles
CHILD = """
import json, sys, time
path, tuned, cfg, kw = sys.argv[1:5]
from hisparse_tpu_torch.utils.hostmem import tune_allocator
if tuned == "1" and not tune_allocator():
    raise SystemExit("tune_allocator failed")
from hisparse_tpu_torch import SpmvConfig, load_npz, pack
m = load_npz(path)
t0 = time.perf_counter()
wp = pack(m, SpmvConfig(**json.loads(cfg)), **json.loads(kw))
print(time.perf_counter() - t0, wp.num_tiles)
"""
PAIRS = 10
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pack_secs(path: str, tuned: bool) -> tuple:
    """(seconds, tiles) of one pack of the npz at ``path`` in a fresh
    process."""
    out = subprocess.run(
        [sys.executable, "-c", CHILD, path, "1" if tuned else "0",
         json.dumps(GOOGLEPLUS_CFG), json.dumps(GOOGLEPLUS_PACK)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    if out.returncode != 0:
        raise RuntimeError(f"hostmem_ab child: {out.stderr[-2000:]}")
    t, tiles = out.stdout.split()[-2:]
    return float(t), int(tiles)


def compare(untuned: list, tuned: list) -> dict:
    """The means, the paired differences' mean and standard error
    (untuned - tuned), the pairs the tuned side won, and the verdict:
    "tuned faster" beyond twice the standard error, "tuned slower" below
    minus twice it, else "unresolved"."""
    diff = [u - t for u, t in zip(untuned, tuned)]
    mean = statistics.fmean(diff)
    se = statistics.stdev(diff) / len(diff) ** 0.5 if len(diff) > 1 else 0.0
    return {"mean_untuned_s": statistics.fmean(untuned),
            "mean_tuned_s": statistics.fmean(tuned),
            "mean_diff_s": mean, "se_diff_s": se,
            "tuned_won": sum(d > 0 for d in diff),
            "verdict": ("tuned faster" if mean > 2 * se
                        else "tuned slower" if mean < -2 * se
                        else "unresolved")}


def run(pairs: int) -> dict:
    """The A/B over ``pairs`` alternating pairs; returns its numbers."""
    t0 = time.perf_counter()
    m = powerlaw_csr(*GOOGLEPLUS["shape"], seed=GOOGLEPLUS["seed"])
    print(f"hostmem_ab: googleplus {m.num_rows} x {m.num_cols}, nnz {m.nnz},"
          f" made in {time.perf_counter() - t0:.1f} s", flush=True)
    untuned, tuned = [], []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "googleplus.npz")
        save_npz(path, m)
        del m
        warm, tiles = pack_secs(path, False)
        print(f"warm-up (untuned, dropped): {warm:.3f} s, {tiles} tiles",
              flush=True)
        for i in range(pairs):
            order = (False, True) if i % 2 == 0 else (True, False)
            got = {}
            for side in order:
                got[side], t = pack_secs(path, side)
                if t != tiles:
                    raise RuntimeError(f"pair {i}: {t} tiles, not {tiles}")
            untuned.append(got[False])
            tuned.append(got[True])
            print(f"pair {i} ({'untuned' if not order[0] else 'tuned'} "
                  f"first): untuned {got[False]:.3f} s, tuned "
                  f"{got[True]:.3f} s", flush=True)
    res = {"pairs": pairs, "tiles": tiles, "warmup_s": warm,
           "untuned_s": untuned, "tuned_s": tuned,
           **compare(untuned, tuned)}
    mean, se = res["mean_diff_s"], res["se_diff_s"]
    print(f"means: untuned {res['mean_untuned_s']:.3f} s, tuned "
          f"{res['mean_tuned_s']:.3f} s; untuned - tuned {mean:.3f} s "
          f"(standard error {se:.3f} s); tuned won {res['tuned_won']} of "
          f"{pairs} pairs; verdict: {res['verdict']}", flush=True)
    return res


def main() -> int:
    print(json.dumps(run(PAIRS)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

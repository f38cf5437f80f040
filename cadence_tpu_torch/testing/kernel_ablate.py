"""A/B timing of edited copies of the FSM kernel's source on one GPU.

    python3 -m cadence_tpu_torch.testing.kernel_ablate [variant ...]

Each variant is ``ops/csrc/replay_fsm.cu`` with one edit that removes or
changes one part of the work, built with the package's ``nvcc`` flags
into ``build/torch_kernels/ablate/<variant>/`` (all at once) and loaded
in place of the kernel's library. Every variant is timed in the same
process, on the same device-resident events, at 65,536 and 16,384 tiled
``retry_deep`` lanes (T = 1,024), int32 and int16: the median of 11
launches timed with CUDA events. Prints the card's name and power limit
(``nvidia-smi``), then one JSON line per shape. What the variants leave
out tells what bounds the kernel:

* ``base``: the kernel as it is;
* ``no_apply``: each step reads its fields from the ring and folds
  them into one register, and applies no transition (the event pipeline
  alone);
* ``no_switch``: the preamble and the version history apply, the type
  switch's groups do not (the divergent paths left out);
* ``one_step_stages``: one step a ring stage (the launcher's depth rule
  off).

Needs a CUDA device and ``nvcc``; the variants' results are not checked
(``no_apply`` and ``no_switch`` compute something else on purpose).
"""

from __future__ import annotations

import ctypes
import json
import random
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _build
from ..ops import pack as P
from ..ops import replay_cuda as RC
from ..ops import schema as S
from . import workloads as W

CAPS = S.Capacities(max_events=1024, max_activities=4, max_timers=2,
                    max_children=2, max_request_cancels=2,
                    max_signals_ext=2, max_version_items=2)
N_UNIQUE, DEPTH = 256, 1000
LANES = (65536, 16384)
REPS = 11

_FOLD = ("ls.x[0] ^= f[0] ^ f[1] ^ f[2] ^ f[3] ^ f[4] ^ f[5] ^ f[6] ^ "
         "f[7] ^ f[8] ^ f[9] ^ f[10] ^ f[11] ^ f[12] ^ f[13] ^ f[14] ^ "
         "f[15];")
VARIANTS = {
    "base": (),
    "no_apply": (("apply_step(ls, st, p, f);", _FOLD),),
    "no_switch": (("  switch (et) {", "  switch (et < 0 ? 0 : 1000) {"),),
    "one_step_stages": (("    if (r <= rounds) {", "    if (kk == 1) {"),),
}


def build_variants(names):
    """Edited copies of the kernel source, compiled in parallel; returns
    {name: library path}."""
    src = (_build._CSRC / "replay_fsm.cu").read_text()
    nvcc = _build._nvcc()

    def one(name):
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        out_dir = _build.BUILD_DIR / "ablate" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "replay_fsm.cu").write_text(text)
        lib = out_dir / "libreplay_fsm.so"
        res = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib),
             str(out_dir / "replay_fsm.cu")],
            capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}"
                               f"{res.stderr}")
        return name, lib

    with ThreadPoolExecutor(len(names)) as ex:
        return dict(ex.map(one, names))


def use_library(path) -> None:
    """Make the kernel wrapper launch the library at ``path``."""
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in _build._SIGNATURES["replay_fsm"].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _build._libs["replay_fsm"] = lib


def median_ms(fn, reps: int = REPS) -> float:
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in ev)[reps // 2]


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ablate: no CUDA device", file=sys.stderr)
        return 2
    names = [n for n in argv if n in VARIANTS] or list(VARIANTS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build_variants(names)
    rng = random.Random(42)
    uniq = P.pack_histories(
        [(f"wf-{i}", f"run-{i}", W.retry_deep_history(rng, depth=DEPTH))
         for i in range(N_UNIQUE)], caps=CAPS)
    teb = uniq.teb()
    narrowed = RC.narrow_events_teb(teb)
    rm = RC.RowMap(CAPS)
    for lanes in LANES:
        reps = lanes // N_UNIQUE
        rows0 = RC.state_to_rows(
            S.state_from_numpy(S.empty_state(lanes, CAPS), "cuda"), rm)
        out = torch.empty_like(rows0)
        streams = {"int32": (teb, None, ()),
                   "int16": (narrowed[0], narrowed[1], narrowed[2])}
        for stream, (host, base, wide) in streams.items():
            ev = torch.from_numpy(np.ascontiguousarray(host)).cuda()
            ev = ev.repeat(1, 1, reps).contiguous()
            line = {"lanes": lanes, "stream": stream,
                    "device": torch.cuda.get_device_name(0)}
            for name, path in libs.items():
                use_library(path)
                line[name] = median_ms(lambda: RC.replay_rows(
                    ev, rows0, CAPS, base, wide, out=out))
            print(json.dumps(line), flush=True)
            del ev
            torch.cuda.empty_cache()
    _build._libs.pop("replay_fsm", None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

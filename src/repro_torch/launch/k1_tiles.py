"""K1's bf16 tile sizes against each other on the card.

    python -m repro_torch.launch.k1_tiles

Builds ``kernels/csrc/flash_attention.cu`` once per configuration, with
the ``Tiles<D, BK, NWG>`` of one head dim changed (BK keys a tile, NWG
warpgroups of 64 query rows a block), into ``build/k1_tiles/``, and
times each against the committed configuration in the same process, in
turns (committed, variants, committed), at the serving paths' shapes:
llama3.2-1b (H=32, KV=8) at D=64 and 128, recurrentgemma-2b (H=10,
KV=1, window 2048) at D=256, S=2048 and the serving S.  Each line gives
a configuration's ms per call (CUDA events) and its largest error
against ``ref.attention_ref``.  Needs a CUDA device.
"""

from __future__ import annotations

import subprocess

import torch

from ..kernels import _build, ref
from ..kernels import flash_attention as fa

#: the committed alias of each head dim, as the source spells it
_ALIAS = "using TilesD{D} = Tiles<{D}, {BK}, {NWG}>;"
COMMITTED = {64: (128, 1), 128: (64, 2), 256: (64, 2)}
VARIANTS = {64: [(128, 2), (64, 2), (64, 1), (192, 2)],
            128: [(128, 2), (128, 1), (64, 1)],
            256: [(64, 1)]}   # BK=128 at D=256 needs 289 KiB: no fit
SHAPES = [  # B, S, H, KV, D, window
    (1, 2048, 32, 8, 64, None), (1, 32, 32, 8, 64, None),
    (1, 2048, 32, 8, 128, None),
    (1, 2048, 10, 1, 256, 2048), (1, 23, 10, 1, 256, 2048),
]


def _variant(D: int, bk: int, nwg: int):
    """The C entry point of the library built with Tiles<D, bk, nwg>."""
    src = fa._SOURCE.read_text()
    old = _ALIAS.format(D=D, BK=COMMITTED[D][0], NWG=COMMITTED[D][1])
    if old not in src:
        raise RuntimeError(f"{old!r} not in {fa._SOURCE}")
    path = _build.BUILD_DIR / "k1_tiles" / f"fa_d{D}_bk{bk}_wg{nwg}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(old, _ALIAS.format(D=D, BK=bk, NWG=nwg)))
    regs = [line.split(": ", 1)[1] for line in _build.ptxas_report(path)
            if f"TilesILi{D}ELi{bk}ELi{nwg}E" in line]
    return _build.function(path, "repro_flash_attention_fwd",
                           fa._ARGTYPES), regs


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    fns = {}
    for D, tiles in VARIANTS.items():
        fns[(D, *COMMITTED[D])] = _build.function(
            fa._SOURCE, "repro_flash_attention_fwd", fa._ARGTYPES)
        for bk, nwg in tiles:
            fns[(D, bk, nwg)], regs = _variant(D, bk, nwg)
            print(f"D={D} BK={bk} NWG={nwg}: {'; '.join(regs)}")
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, KV, D, window in SHAPES:
        q = torch.randn((B, S, H, D), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, S, KV, D), generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        want = ref.attention_ref(q, k, v, window=window).float()
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn) -> int:
            return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      B, S, H, KV, D, 1, window or 0, 0.0, stream)

        cells = []
        for bk, nwg in [COMMITTED[D]] + VARIANTS[D] + [COMMITTED[D]]:
            fn = fns[(D, bk, nwg)]
            code = call(fn)
            torch.cuda.synchronize()
            if code:
                cells.append(f"BK={bk} NWG={nwg} refused (CUDA error "
                             f"{code})")
                continue
            err = (o.float() - want).abs().max().item()
            ms = _time_ms(lambda: call(fn), 200 if S <= 32 else 50)
            cells.append(f"BK={bk} NWG={nwg} {ms:.5f} ms (err {err:.2e})")
        print(f"B={B} S={S} H={H} KV={KV} D={D}"
              + (f" window {window}" if window else "") + ": "
              + " | ".join(cells))


if __name__ == "__main__":
    main()

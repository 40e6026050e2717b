"""The near ties behind the cotangent mask of the max kernels' wide card
test, shown on one case of ``tests/test_torch_max.py`` (``make_case``; by
default random, H = O = 520, erf-GELU, f32 edges).

#9, #10 and #11 of this build and of another build of
``csrc/ell_max_kernels.cu`` (an earlier revision) run on the same inputs
with the unmasked cotangent, each against its own forward's maxima, as the
card test runs them. For each build the script prints the entries of
geq_rows beyond the test's BWD_TOL of the plain version's, and whether its
maxima, counts, geq_rows, g_z and g_W are the other build's bits. Then, for
each (key, o) where the card's winning slot is not the plain version's:
the two slots, each one's product as the plain version forms it (f32, a
rounded multiply and add a term), as the card forms it (this build's #9 on
a plan of one-slot rows) and exactly (f64), and each side's key max.

    git show <rev>:sir_gcn_tpu_torch/csrc/ell_max_kernels.cu > other.cu
    python tests/max_near_tie_probe.py other.cu [--graph random --h 520 \\
        --o 520 --act gelu --dt f32]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

import test_torch_max as base  # noqa: E402
from sir_gcn_tpu_torch.ops.cuda.kernels import (  # noqa: E402
    _library,
    ell_max_bwd_plain,
    ell_max_fwd_plain,
    slot_act,
    slot_products,
)
from sir_gcn_tpu_torch.tools import card_line  # noqa: E402
from sir_gcn_tpu_torch.tools.ell_ab import (  # noqa: E402
    build_other,
    max_launches,
    max_scratch,
)

OUTPUTS = ("rows", "counts", "geq", "gz", "gw")


def key_winners(m, keys, n_keys):
    """[V, O] True where slot v's m is its key's max at o, and the max."""
    top = torch.full((n_keys, m.shape[1]), -float("inf"), dtype=m.dtype,
                     device=m.device)
    top.scatter_reduce_(0, keys[:, None].expand(-1, m.shape[1]), m, "amax")
    return m == top[keys], top


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("near ties of the max kernels' card test")
    p.add_argument("other", type=Path,
                   help="a source with the C interface of ell_max_kernels.cu")
    p.add_argument("--graph", default="random")
    p.add_argument("--h", type=int, default=520)
    p.add_argument("--o", type=int, default=520)
    p.add_argument("--act", default="gelu", choices=sorted(base.ACTS))
    p.add_argument("--dt", default="f32", choices=sorted(base.DTYPES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    device = torch.device("cuda")
    print(card_line(), flush=True)
    c = base.make_case(args.graph, args.h, args.o, device=device)
    tact, dtype = base.ACTS[args.act], base.DTYPES[args.dt]
    pargs = base._port_args(c, dtype, device)
    eq, ek, slot_src, scale, row_key, row_ptr, w = pargs
    plan = c.fg.dst_plan
    gsc = base._t(c.g, device=device)

    libs = {"other": build_other(args.other, "ell_max_kernels"),
            "this": _library("ell_max_kernels")}
    inp = dict(fg=c.fg, eq=eq, ek=ek, dtype=dtype, scale=scale)
    part = max_scratch(libs, inp, args.h, args.o, tact)
    outs = {k: max_launches(lib, inp, w, gsc, tact, part)[1]
            for k, lib in libs.items()}
    rows_p = ell_max_fwd_plain(*pargs, tact)
    key_max_p = plan.finalize_rows_max(rows_p)
    geq_p = ell_max_bwd_plain(*pargs, key_max_p, gsc, tact)[0]
    print(f"case {args.graph}, H = {args.h}, O = {args.o}, {args.act}, "
          f"{args.dt}", flush=True)
    rec = {}
    for k, out in outs.items():
        far = ~torch.isclose(out["geq"], geq_p, **base.BWD_TOL)
        rec[k] = int(far.sum())
        print(f"{k}: geq_rows beyond BWD_TOL of the plain version's at "
              f"{rec[k]} of {far.numel()}", flush=True)
    same = {n: torch.equal(outs["other"][n], outs["this"][n])
            for n in OUTPUTS}
    print("the other build's bits: " + ", ".join(
        f"{n} {'same' if v else 'differ'}" for n, v in same.items()),
        flush=True)

    # each valid slot's product three ways, and the winners of each key
    one, row = base._one_slot_products(c, pargs, tact)
    vs = (scale > 0).nonzero().flatten()
    keys = row_key[row].long()
    z = ek[slot_src[vs].long()].float() + eq[keys]
    a = slot_act(tact, z)
    plain = slot_products(a, w)
    exact = a.double() @ w.double()
    n_keys = int(key_max_p.shape[0])
    win_p, _ = key_winners(plain, keys, n_keys)
    win_c, _ = key_winners(one, keys, n_keys)
    flips = []
    for o in (win_p != win_c).any(0).nonzero().flatten().tolist():
        for key in keys[(win_p[:, o] != win_c[:, o])].unique().tolist():
            mine = (keys == key).nonzero().flatten()
            sp = mine[win_p[mine, o]][0]
            sc = mine[win_c[mine, o]][0]
            flips.append((key, o))
            print(f"(key {key}, o {o}): the plain version's winner slot "
                  f"{int(vs[sp])}, the card's slot {int(vs[sc])}", flush=True)
            for name, s in (("plain's", sp), ("card's", sc)):
                print(f"  {name} winner: plain {float(plain[s, o])!r}, card "
                      f"{float(one[s, o])!r}, exact {float(exact[s, o])!r}",
                      flush=True)
            print(f"  gap: plain {float(plain[sp, o] - plain[sc, o])!r}, card "
                  f"{float(one[sc, o] - one[sp, o])!r}, exact "
                  f"{float(exact[sp, o] - exact[sc, o])!r}", flush=True)
            print(f"  key max: plain {float(key_max_p[key, o])!r}, this "
                  f"{float(outs['this']['key_max'][key, o])!r}, other "
                  f"{float(outs['other']['key_max'][key, o])!r}", flush=True)
    print(f"{len(flips)} (key, o) with another winner on the card",
          flush=True)
    return dict(beyond=rec, same_bits=same, flips=flips)


if __name__ == "__main__":
    main()

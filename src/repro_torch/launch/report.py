"""Roofline post-processing and the dry-run tables, as
``repro.launch.report``: closed-form per-(arch x shape x mesh) accounting
with documented coefficients, divided by the card's rates (``launch.
roofline.HW``: an NVIDIA H100's data sheet). All terms are per-card seconds.

Why analytic terms: a compiled program's own cost counts do not see how
often a layer loop runs; these closed forms do.

Coefficients (matmul-flops conventions):
  train flops  = 8·N_active·T  (2 fwd + 4 bwd + 2 remat-refwd)   [remat on]
  prefill      = 2·N_active·T ; decode = 2·N_active·B
  attention    = 4·Hq·hd·Σpairs·mult, Σpairs: causal S²/2, window S·W,
                 decode B·S_cache; mult: train 4 (fwd+bwd+remat), else 1
  HBM train    = 38·N/chips (bf16 reads ×3 + f32 adam rw ×6 + grads)
                 + 24·L·T·D·2/chips (activation traffic, remat)
                 + 3·T·V·4/chips (chunked logits+loss fwd/bwd)
  HBM decode   = (2·N_active + KV cache + 3·B·V·4 logits)/chips
  collective   = ring all-reduce ≈ 2×payload:
    train: DP grads 2·(N/model)·gbytes + TP 12·L·(T/dp)·D·2 + logits T/dp·V·4
    decode: TP 4·L·(B/dp)·D·2 + logits (B/dp)·V·4
  ideal (fraction denominator's numerator): useful flops (6·N·T train /
    2·N·T else + attention at mult 3/1) vs unavoidable bytes (params+opt
    traffic; decode: params+KV read).
"""
from __future__ import annotations

import json

from repro_torch.configs.base import SHAPES, ArchConfig, get_arch
from repro_torch.launch.roofline import HW


def geometry(cfg: ArchConfig) -> dict:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        L_attn = cfg.n_layers
    elif fam == "hybrid":
        L_attn = cfg.n_layers // cfg.attn_every
    elif fam == "encdec":
        L_attn = cfg.n_enc_layers + 2 * cfg.n_layers  # self + cross
    else:
        L_attn = 0
    L_win = cfg.n_layers // 2 if cfg.alt_local_global else 0
    L_full = L_attn - L_win
    return {"L_attn": L_attn, "L_full": L_full, "L_win": L_win}


def analytic_cell(arch: str, shape_name: str, mesh: str, n_params: int,
                  n_active: int, *, bf16_grads: bool = True) -> dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    chips = 512 if mesh == "2x16x16" else 256
    model_par = 16
    dp = chips // model_par
    g = geometry(cfg)
    B, S = shape.global_batch, shape.seq_len
    Hq, hd, D, V, L = cfg.n_heads, cfg.hd, cfg.d_model, cfg.vocab_size, cfg.n_layers
    kind = shape.kind
    T = B * S if kind != "decode" else B
    gb = 2 if bf16_grads else 4

    if kind == "train":
        mult, c_p = 4, 8 if cfg.remat else 6
    else:
        mult, c_p = 1, 2

    # ---- flops ----
    flops = c_p * n_active * T
    if kind == "decode":
        pairs = B * S * g["L_full"]  # every attn layer reads the cache
        pairs += B * min(S, cfg.sliding_window or S) * g["L_win"]
    else:
        pairs = B * S * S / 2 * g["L_full"] + \
            B * S * min(S, cfg.sliding_window or S) * g["L_win"]
    flops += 4 * Hq * hd * pairs * mult
    flops_useful = (6 if kind == "train" else 2) * n_active * T + \
        4 * Hq * hd * pairs * (3 if kind == "train" else 1)

    # ---- hbm bytes (per chip) ----
    if kind == "train":
        hbm = (38 * n_params + 24 * L * T * D * 2 + 3 * T * V * 4) / chips
        useful_bytes = (30 * n_params) / chips
    elif kind == "prefill":
        kv_bytes = g["L_attn"] * 2 * B * S * cfg.n_kv_heads * hd * 2
        hbm = (2 * n_active + 8 * L * T * D * 2 + kv_bytes + B * V * 4) / chips
        useful_bytes = (2 * n_active + kv_bytes) / chips
    else:
        kv_bytes = g["L_attn"] * 2 * B * S * cfg.n_kv_heads * hd * 2
        state_bytes = 0
        if cfg.ssm_state:
            d_inner = cfg.ssm_expand * D
            state_bytes = cfg.n_layers * B * (d_inner // cfg.ssm_headdim) * \
                cfg.ssm_headdim * cfg.ssm_state * 4
        if cfg.slstm_every:
            d_inner = int(cfg.proj_factor * D)
            P_ = d_inner // cfg.n_heads
            state_bytes = (L * 3 // 4) * B * cfg.n_heads * P_ * P_ * 4
        hbm = (2 * n_active + kv_bytes + state_bytes + 3 * B * V * 4) / chips
        useful_bytes = (2 * n_active + kv_bytes + state_bytes) / chips

    # ---- collective bytes (per chip) ----
    if kind == "train":
        coll = 2 * (n_params / model_par) * gb \
            + 12 * L * (T / dp) * D * 2 + (T / dp) * V * 4
    elif kind == "prefill":
        coll = 4 * L * (T / dp) * D * 2 + (B / min(dp, B)) * V * 4
    else:
        bloc = B / min(dp, B)
        coll = 4 * L * bloc * D * 2 + bloc * V * 4

    t_c = flops / chips / HW["peak_flops"]
    t_m = hbm / HW["hbm_bw"]
    t_x = coll / HW["link_bw"]
    bound = max(t_c, t_m, t_x)
    ideal = max(flops_useful / chips / HW["peak_flops"],
                useful_bytes / HW["hbm_bw"])
    dom = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(dom, key=dom.get)
    hints = {
        "compute": "cut remat re-compute (selective policies) / bigger tensor-core tiles",
        "memory": "shrink optimizer+activation traffic (ZeRO-3, fused kernels, "
                  "quantized KV)",
        "collective": "overlap TP all-reduces with compute; bf16/int8 grad "
                      "reduction; reduce-scatter+all-gather instead of all-reduce",
    }
    return {
        "an_flops": flops, "an_hbm_per_chip": hbm, "an_coll_per_chip": coll,
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
        "dominant": dominant, "bound_s": bound, "ideal_s": ideal,
        "roofline_fraction": ideal / bound if bound > 0 else 0.0,
        "useful_flops_ratio": flops_useful / max(flops, 1.0),
        "model_flops": (6 if kind == "train" else 2) * n_active * T,
        "hint": hints[dominant],
    }


def load_and_annotate(path: str = "experiments/torch_dryrun.json") -> list[dict]:
    with open(path) as f:
        recs = json.load(f)
    for r in recs:
        if r.get("status") != "ok":
            continue
        r["analytic"] = analytic_cell(
            r["arch"], r["shape"], r["mesh"], r["n_params"],
            r["n_active_params"])
    return recs


def fmt_seconds(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def dryrun_table(recs: list[dict]) -> str:
    lines = ["| arch | shape | mesh | status | count | bytes/device | "
             "colls (AG/AR/RS/A2A/CP) |",
             "|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r.get("status") == "ok":
            by = r["collectives"]["by_kind"]
            cc = "/".join(str(by[k]["count"]) for k in
                          ("all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute"))
            mem = r["memory"].get("total_device_bytes", 0) / 2 ** 30
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                         f"{r.get('count_s', r.get('compile_s', 0)):.0f}s | {mem:.2f} GiB | "
                         f"{cc} |")
        else:
            why = r.get("reason", r.get("error", ""))[:60]
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"{r['status']} | - | - | {why} |")
    return "\n".join(lines)


def roofline_table(recs: list[dict], mesh: str = "16x16") -> str:
    lines = ["| arch | shape | compute | memory | collective | dominant | "
             "MODEL/total flops | fraction | what would move it |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") != "ok" or r["mesh"] != mesh or "analytic" not in r:
            continue
        a = r["analytic"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_seconds(a['t_compute_s'])} | "
            f"{fmt_seconds(a['t_memory_s'])} | {fmt_seconds(a['t_collective_s'])} | "
            f"{a['dominant']} | {a['useful_flops_ratio']:.2f} | "
            f"{a['roofline_fraction']:.3f} | {a['hint']} |")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    rates = HW.get("name", "the HW rates")
    ap = argparse.ArgumentParser(description=f"Dry-run and analytic roofline tables ({rates}).")
    ap.add_argument("--in", dest="inp", default="experiments/torch_dryrun.json")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    recs = load_and_annotate(args.inp)
    print("## Dry-run\n")
    print(dryrun_table(recs))
    print(f"\n## Roofline (single pod, analytic, {rates})\n")
    print(roofline_table(recs, args.mesh))


if __name__ == "__main__":
    main()

"""W8A8 against bf16 products at the DiT's hot-loop shapes on the card.
Counterpart of examples/bench_int8.py.

Times a 24-layer scan of the DiT's SwiGLU MLP (three products a layer,
2048 -> 5888 -> 2048) and one of its five square projections (wq, wk,
wv, gate, wo), each repeated 4 times in one timed call, at the CFG steps'
row count (G x B x S = 3 x 640 = 1920 rows):

  bf16        x @ w^T, both bf16 (the serving path)
  w8a8        ops.quant.int8_dot: int8 weights, the activations quantized
              per row, the int8 product into int32 (kernel C)
  int8-pure   torch._int_mm on operands quantized beforehand, the same
              products with no quantization work: a yardstick only, the
              port never calls it
  w8-dequant  the int8 weights dequantized to bf16, then the bf16 product
              (what weight-only quantization would buy: memory, not
              operations)

each the median of --reps calls on the host clock between synchronises,
as TFLOP/s and against bf16.  Beside them, one product's relative error
against fp32 in W8A8 and in bf16 (w8a8_error, fp32 activations).  One JSON line:
{"metric": "int8_matmul_scans", "mlp": {...}, "proj": {...}, ...}.

    python -m echo_tts_torch.examples.bench_int8
    python -m echo_tts_torch.examples.bench_int8 --tiny --device cpu
"""
from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from ..ops.int8_matmul import int8_matmul_plain, quantize_last
from ..ops.quant import dequantize_weight, int8_dot, quantize_weight_int8
from . import stages

FULL = dict(layers=24, rows=3 * 640, d=2048, f=5888, repeat=4)
TINY = dict(layers=2, rows=24, d=64, f=96, repeat=1)


def w8a8_error(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """(W8A8, bf16) relative errors of x @ w^T against fp32: x (M, K) and
    w (N, K) fp32, the weight quantized by quantize_weight_int8.  The W8A8
    product is kernel C's function on the fp32 activations
    (int8_matmul_plain: the kernel takes bf16 ones, and is held to this
    function in chip_smoke.py phase 4)."""
    ref = x @ w.t()
    q8, s = quantize_weight_int8(w)
    got = int8_matmul_plain(x, q8, s, torch.float32)
    bf = (x.to(torch.bfloat16) @ w.to(torch.bfloat16).t()).float()
    norm = torch.linalg.norm(ref)
    return (float(torch.linalg.norm(got - ref) / norm),
            float(torch.linalg.norm(bf - ref) / norm))


def _weights(shapes: dict, layers: int, device, seed: int) -> dict:
    """Per name: bf16 (L, N, K), and the int8 weight with its scales."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, (n, k) in shapes.items():
        w = (torch.randn((layers, n, k), generator=g, device=device)
             / math.sqrt(k)).to(torch.bfloat16)
        out[name] = (w, *quantize_weight_int8(w))
    return out


def _variants(ws: dict) -> dict:
    """Each variant's product of x with layer i of weight `name`."""
    return {
        "bf16": lambda x, name, i: x @ ws[name][0][i].t(),
        "w8a8": lambda x, name, i: int8_dot(x, ws[name][1][i], ws[name][2][i]),
        "w8-dequant": lambda x, name, i: x @ dequantize_weight(
            ws[name][1][i], ws[name][2][i], torch.bfloat16).t(),
    }


def scans(shape: dict, device, args) -> dict:
    """{"mlp": {variant: {ms, tflops, vs_bf16}}, "proj": {...}}."""
    layers, m, d, f, repeat = (shape[k] for k in
                               ("layers", "rows", "d", "f", "repeat"))
    g = torch.Generator(device=device).manual_seed(0)
    h0 = torch.randn((m, d), generator=g, device=device).to(torch.bfloat16)
    mlp_w = _weights({"w1": (f, d), "w3": (f, d), "w2": (d, f)}, layers,
                     device, 1)
    proj_w = _weights({f"p{i}": (d, d) for i in range(5)}, layers, device, 2)

    def mlp(mm):
        def run():
            h = h0
            for _ in range(repeat):
                for i in range(layers):
                    y = F.silu(mm(h, "w1", i)) * mm(h, "w3", i)
                    h = (h + mm(y, "w2", i)).to(h0.dtype)
            return h
        return run

    def proj(mm):
        def run():
            h = h0
            for _ in range(repeat):
                for i in range(layers):
                    acc = h
                    for p in range(5):
                        acc = acc + mm(h, f"p{p}", i)
                    h = (acc / 6.0).to(h0.dtype)
            return h
        return run

    # int8-pure: the same products on operands quantized beforehand
    hq = quantize_last(h0, 127.0)[0].to(torch.int8)
    yq = torch.randint(-127, 128, (m, f), generator=g, device=device,
                       dtype=torch.int8)

    def pure(ws, operands):
        def run():
            for _ in range(repeat):
                for i in range(layers):
                    for name, x in operands:
                        torch._int_mm(x, ws[name][1][i].t())
        return run

    out = {}
    for tag, build, ws, operands, flops in (
            ("mlp", mlp, mlp_w, [("w1", hq), ("w3", hq), ("w2", yq)],
             2.0 * m * d * f * 3 * layers * repeat),
            ("proj", proj, proj_w, [(f"p{p}", hq) for p in range(5)],
             2.0 * m * d * d * 5 * layers * repeat)):
        mm = _variants(ws)
        fns = {"bf16": build(mm["bf16"]), "w8a8": build(mm["w8a8"]),
               "int8-pure": pure(ws, operands),
               "w8-dequant": build(mm["w8-dequant"])}
        rows = {}
        with torch.inference_mode():
            for name, fn in fns.items():
                _, runs = stages.timed_stage(fn, args)
                ms = stages.median(runs)
                rows[name] = {"ms": ms, "tflops": flops / (ms / 1e3) / 1e12,
                              "range_ms": stages.span(runs)}
        for r in rows.values():
            r["vs_bf16"] = rows["bf16"]["ms"] / r["ms"]
        out[tag] = dict(rows, tflop_per_call=flops / 1e12)
    return out


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, reps=5)
    args = stages.parse(ap, argv)
    dev = models.device if models is not None else stages.device(ap, args)
    shape = TINY if args.tiny else FULL
    out = scans(shape, dev, args)
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn((shape["f"], shape["d"]), generator=g,
                    device=dev) / math.sqrt(shape["d"])
    x = torch.randn((shape["rows"], shape["d"]), generator=g, device=dev)
    rel, rel_bf16 = w8a8_error(x, w)
    return stages.emit({"metric": "int8_matmul_scans", **out,
                        "w8a8_rel_err_vs_f32": rel,
                        "bf16_rel_err_vs_f32": rel_bf16}, dev)


if __name__ == "__main__":
    sys.exit(main())

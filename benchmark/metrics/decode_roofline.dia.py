"""Dia's frame loop against its memory roofline: the bytes each decode
step launched must move (the decoder's weights and head once, the self
K/V at the length bucket read, the cross K/V at the text width launched,
the step's writes: benchmark/dia_counts.py) at 3.35 TB/s, over the
device's busy time inside the program's `dia.decode` spans (%)."""
from benchmark import dia_counts


def _busy_within(device, spans):
    """Union of the device intervals clipped to the spans, in seconds."""
    total = 0
    for s0, s1 in spans:
        cur_s = cur_e = None
        for s, e, _ in device:
            s, e = max(s, s0), min(e, s1)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
    return total / 1e9


def read(ctx):
    cfg = ctx.cell.config["dia"]
    least, spans = 0.0, []
    for p in ctx.passes:
        dec = getattr(p, "stages", {}).get("dia.decode")
        if not dec or not p.attn_bucket:
            continue
        spans += dec
        for n in dia_counts.step_lengths(p.steps, max(p.prompt_frames),
                                         p.attn_bucket, p.capacity):
            least += dia_counts.decode_step_bytes(
                cfg, 2 * p.rows, n, p.text_width) / dia_counts.PEAK_BYTES
    t = _busy_within(ctx.trace.device, spans)
    if t <= 0:
        return None
    return 100.0 * least / t

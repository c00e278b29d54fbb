"""K7, the tail accumulate (`ops/csrc/tail.cu`): its arguments and result
once, and a coverage test for each (slot under the budget, sample) pair."""

from harness.roofline import PAIR_TEST_OPS, nbytes


def _tail_accumulate(args, kw, out):
    fields, meta, band, rect, cut, params_row = args[:6]
    budget = kw["budget"]
    budget_lo = kw.get("budget_lo", 0)
    slots = int((meta[5].clamp(max=budget) - budget_lo).clamp(min=0).sum())
    moved = nbytes(fields, meta, band, rect, cut, params_row,
                   kw.get("slot_mask"), out)
    return moved, slots * kw["s_cy"] * kw["s_cx"] * PAIR_TEST_OPS


WRAPPERS = [
    ("fourdgs_torch.ops.tail_cuda", "tail_accumulate", "K7",
     _tail_accumulate),
]

"""K9, the tail accumulate's backward (`ops/csrc/tail_bwd.cu`), where the
converged fit step's backward calls it (inside the autograd Function's
backward, once a stream): its arguments and the fields' gradient once,
and a coverage test for each (slot under the budget, sample) pair, as
K7."""

from harness.roofline import PAIR_TEST_OPS, nbytes


def _tail_accumulate_bwd(args, kw, out):
    fields, meta, band, cut, params_row, d_acc = args[:6]
    slot_mask = args[6] if len(args) > 6 else kw.get("slot_mask")
    budget = kw["budget"]
    budget_lo = kw.get("budget_lo", 0)
    slots = int((meta[5].clamp(max=budget) - budget_lo).clamp(min=0).sum())
    moved = nbytes(fields, meta, band, cut, params_row, d_acc, slot_mask,
                   kw.get("wd_ab"), out)
    return moved, slots * kw["s_cy"] * kw["s_cx"] * PAIR_TEST_OPS


WRAPPERS = [
    ("fourdgs_torch.ops.tail_cuda", "tail_accumulate_bwd", "K9",
     _tail_accumulate_bwd),
]

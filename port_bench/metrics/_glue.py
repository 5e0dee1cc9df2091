"""Glue time of a packed pass from the program's stage reports
(``PackedGridder.report_timing`` / ``report_timing_degrid``: device time
of each stage by CUDA events inside one pass, mean of 10): every stage
but the stack kernel's."""

KERNEL_STAGES = {"grid": "stack kernel", "degrid": "fused degrid kernel"}


def glue_ms(ctx, side: str):
    report = (ctx.get("spans") or {}).get(side)
    if not report:
        return None
    kernel = KERNEL_STAGES[side]
    if kernel not in report:
        return None
    return 1e3 * sum(sec for name, sec in report.items() if name != kernel)

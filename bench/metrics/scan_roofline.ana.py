"""scan_roofline.ana: the exact scans' least time / their device time in
the traced stretch, in %. The least time is the benchmark's own count
(`yardstick.scan_bound_s`) for each launch shape the program's counters
report for `scan_exact` and `scan_exact_join` in the stretch; the device
time is that of the kernels named `scan_exact_kernel`."""

from bench import yardstick

KERNELS = ("scan_exact", "scan_exact_join")


def read(run):
    t = run.trace
    if t is None:
        return None
    bound = sum(yardstick.scan_bound_s(shape) * count
                for name in KERNELS
                for shape, count in t.launch_shapes.get(name, {}).items())
    timed = t.op_seconds(lambda n: "scan_exact_kernel" in n)
    if not bound or not timed:
        return None
    return yardstick.share(bound, timed)

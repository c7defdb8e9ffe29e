"""ssm_roofline.train: the selective scan's (K17) and its backward's least
time / their device time in the traced stretch, in %. The least time of a
launch is the larger of its bytes at the HBM rate and its exponentials on
the SFUs at the card's highest SM clock (`yardstick.ssm_bound_s`), for
each launch shape the program's counters report; the device time is that
of the kernels named `selective_scan_kernel` and
`selective_scan_bwd_kernel`. The run records which bound binds."""

from bench import yardstick


def read(run):
    t = run.trace
    clock = run.extra.get("sm_clock_hz")
    sms = run.extra.get("sms")
    if t is None or not clock or not sms:
        return None
    bound, binds = 0.0, {}
    for name, backward in (("selective_scan", False),
                           ("selective_scan_bwd", True)):
        for shape, count in t.launch_shapes.get(name, {}).items():
            b, which = yardstick.ssm_bound_s(shape, backward, sms, clock)
            bound += b * count
            binds[name] = which
    timed = t.op_seconds(lambda n: "selective_scan_kernel" in n
                         or "selective_scan_bwd_kernel" in n)
    if not bound or not timed:
        return None
    run.extra.setdefault("readings", {})["ssm_bound_binds"] = binds
    return yardstick.share(bound, timed)

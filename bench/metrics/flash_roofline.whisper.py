"""flash_roofline.whisper: the blocked attention's launches' least time /
their device time in the traced stretch, in %. The least time of a launch
is the larger of its products at the tensor cores' bf16 rate and its
exponentials on the SFUs at the card's highest SM clock
(`whisper_yardstick.flash_bound_s`), for each launch shape the program's
counters report under ``flash_attention`` and ``flash_attention_bwd``; the
device time is that of the kernels named ``flash_fwd*`` and
``flash_bwd*`` (``csrc/flash_attn.cu``). The run records which bound
binds."""

from bench import whisper_yardstick, yardstick


def _flash(name: str) -> bool:
    return "flash_fwd" in name or "flash_bwd" in name


def read(run):
    t = run.trace
    clock = run.extra.get("sm_clock_hz")
    sms = run.extra.get("sms")
    if t is None or not clock or not sms:
        return None
    bound, binds = 0.0, {}
    for name, backward in (("flash_attention", False),
                           ("flash_attention_bwd", True)):
        for shape, count in t.launch_shapes.get(name, {}).items():
            b, which = whisper_yardstick.flash_bound_s(shape, backward, sms,
                                                       clock)
            bound += b * count
            binds[name] = which
    timed = t.op_seconds(_flash)
    if not bound or not timed:
        return None
    run.extra.setdefault("readings", {})["flash_bound_binds"] = binds
    return yardstick.share(bound, timed)

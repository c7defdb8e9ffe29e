"""flash_roofline.jamba: the blocked attention's launches' least time /
their device time in the traced stretch, in %, read as
``flash_roofline.whisper`` reads it: each launch shape the program's
counters report under ``flash_attention`` and ``flash_attention_bwd``
bounded by `whisper_yardstick.flash_bound_s` (its products at the tensor
cores' bf16 rate, or its exponentials on the SFUs), against the device
time of the kernels named ``flash_fwd*`` and ``flash_bwd*``. In Jamba's
cell the shapes are the two attention layers' (1, 32,768, 32,768, 20, 1,
128, causal)."""

from bench import harness

read = harness.load_module(harness.BENCH / "metrics"
                           / "flash_roofline.whisper.py",
                           "bench_metric_flash_roofline_whisper").read

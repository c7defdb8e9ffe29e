"""encode_ms.whisper: the encoder's stream time a step, in ms: the device
time between the two CUDA events of the program's ``encdec.encode`` spans
(the front end and the encoder layers' forward, one span a micro-batch),
summed over the traced stretch and divided by its steps
(`bench/program_trace.py`); None without a card or without the spans."""

from bench import program_trace


def read(run):
    recs = program_trace.stretch(run)
    n = program_trace.steps(recs)
    got = [r.device_ms for r in recs
           if r.name == "encdec.encode" and r.device_ms is not None]
    if not n or not got:
        return None
    return sum(got) / n

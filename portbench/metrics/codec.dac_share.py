"""Share of the window spent in `UniMoEAudio.decode_slot_results` (DAC
decode of the retired requests to waveforms), from the harness's spans."""

from harness.readers import window_span_s


def read(run):
    if "occupancy" not in run.layer or run.layer["window_s"] <= 0:
        return None
    return window_span_s(run, "decode_slot_results") / run.layer["window_s"]

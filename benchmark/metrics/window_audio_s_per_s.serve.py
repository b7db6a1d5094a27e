"""Audio seconds served a second over the window (strings out and scored,
host clock): the serving rate, which moves with the host's speed."""


def read(trace):
    return trace.get("window_audio_s_per_s")

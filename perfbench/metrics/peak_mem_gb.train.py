"""The device's peak allocated memory over the window (the peak counter
reset at the window's start), in GB."""


def read(rec: dict):
    return rec["peak_window_bytes"] / 1e9

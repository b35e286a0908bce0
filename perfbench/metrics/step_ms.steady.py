"""Engine layer (``serving/engine.py``): the window over the engine steps
it ran, in ms."""


def read(rec: dict):
    if not rec["steps"]:
        return None
    return 1e3 * rec["window_s"] / rec["steps"]

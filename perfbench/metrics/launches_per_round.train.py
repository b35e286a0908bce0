"""The fused round step's device kernels per round, from the trace."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not rec["rounds"]:
        return None
    return tr["kernels"] / rec["rounds"]

"""setup_s: seconds from the process's start to the start of the lead-in
(serving) or of the window (training): imports, the kernels' load or
build, the weights, the warm-up; host clock."""


def read(rec: dict) -> float:
    return rec["setup_s"]

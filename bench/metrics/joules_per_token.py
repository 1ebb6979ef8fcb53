"""joules_per_token: the card's energy over the window (NVML's total
energy counter) over the tokens processed in it: prompt tokens prefilled
and tokens generated (serving), tokens trained (training)."""


def read(rec: dict) -> float | None:
    if not rec["tokens"]:
        return None
    return rec["energy_j"] / rec["tokens"]

"""The atoms served in the window over the rows of the bins that served
them (bins per bucket times its capacity), in %.
None when the run has nothing to read."""


def read(record):
    return 100.0 * record["atoms"] / record["bin_atoms"] if record.get("bin_atoms") else None

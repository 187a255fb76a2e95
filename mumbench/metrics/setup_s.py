"""setup_s: seconds from the process's start to the first timed call:
imports, CUDA context, kernel build or load, generating the collection and
a cold call and a warm one."""


def read(rec):
    return rec["setup_s"]

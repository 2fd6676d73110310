"""Patches in the clouds of every job of the window (the PLY each one
delivered), over the window's wall time: from its opening to the return
of the last job, every job that started while it was open having run to
its end. Speculative waste earns nothing."""


def read(rec):
    return rec["delivered"] / rec["window_s"]

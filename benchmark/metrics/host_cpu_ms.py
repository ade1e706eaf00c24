"""Host CPU time a step, in ms: the process's CPU time (time.process_time,
every thread) around each step call of the unprofiled stretch, as a mean.
It holds the loop thread's Python, dispatch and launches and the autograd
engine thread's, which runs a CUDA backward: the loop thread's time alone
leaves the backward out."""


def read(ctx):
    return ctx.host_cpu_s * 1e3

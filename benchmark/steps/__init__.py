"""The program's training steps by kind, each a module that a workload's
"step" names: ``build(flags, workload, params, state)``, the step as the
app builds it, driven by the benchmark's inputs, and ``calls(flags,
workload)``, its fused calls for the work counts. The kind's reference is
the module of the same name under reference/."""

"""int8 expert products (`torch._int_mm` calls, the port's
`dispatch.int8_expert_matmul.calls` counter) in the window over its decode
steps."""


def read(run):
    steps = run.layer.get("steps")
    if "int8_calls" not in run.layer or not steps:
        return None
    return run.layer["int8_calls"] / steps

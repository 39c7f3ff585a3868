"""setup_s: seconds from the start of run.py to the first timed step or
request (imports, CUDA, the kernel library, the studies, the weights and
model, the first steps or every study size once), host clock."""


def read(ctx):
    return ctx.setup_s

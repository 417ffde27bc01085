"""Job kinds: each module here is one kind, named by a traffic file's
"job" key, with setup(ctx) -> jobs, run(ctx, job, k) -> record,
end_to_end(ctx) -> {metric: value}, check(ctx) -> verdict and
SPANS() -> the port's functions a traced run wraps in spans."""

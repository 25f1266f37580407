"""From the benchmark process's start to the end of warm-up: the server's
process started, the weights made (or found for this seed), the model
loaded, the kernels built (a first run in a checkout), the port's warmup,
and one request per format and top_k through the HTTP server."""


def read(ctx):
    return ctx["setup_s"]

"""Host time of a served frame's one transfer, a frame: the program's
``serve.to_host`` span, from the counter stack through the copy to the
unpacked arrays, the host's wait for the card included."""

from harness import spans


def read(r):
    if r.kind != "serve":
        return None
    return spans.self_ms(r, ("serve.to_host",))

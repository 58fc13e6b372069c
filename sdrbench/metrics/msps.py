"""msps (Msamples/s, host clock): every input sample of every chunk sent in
a closed-loop window, all of which finished in it, over the whole window
(first dispatch to the last chunk's end). An IQ sample counts once.
``msps.dev`` reads the same in the device-bound cells, whose runs spread
far less than a host-bound cell's and so hold a bound of their own."""


def read(ctx):
    w = ctx.window
    return w.samples / w.seconds / 1e6 if w.kind == "closed" else None

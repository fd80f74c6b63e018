"""The device's idle share over the traced window, in percent: one minus
each card's union of device intervals over the span of every rank's
window, averaged over the cards."""


def read(trace):
    return 100.0 * trace.idle_share()

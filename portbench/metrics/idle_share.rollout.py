"""idle_share.rollout (%): the share of the untraced window in which no
kernel, copy or fill ran on the card, from the device time a call took in
the traced window (``share.idle_share``)."""

from portbench.metrics import share


def read(run):
    return share.idle_share(run, "calls")

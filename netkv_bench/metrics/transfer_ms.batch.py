"""Transfer: mean of cluster.walls' transfer_s (host time), ms."""

from nkb.readers import transfer_ms as read  # noqa: F401

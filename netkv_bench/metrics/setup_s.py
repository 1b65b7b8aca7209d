"""Seconds from process start to the window's first due request (host clock)."""

from nkb.readers import setup_s as read  # noqa: F401

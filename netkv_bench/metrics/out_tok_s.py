"""Output tokens delivered in the window over its seconds (host clock)."""

from nkb.readers import out_tok_s as read  # noqa: F401

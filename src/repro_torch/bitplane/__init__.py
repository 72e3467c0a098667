"""Bitplane codec: the entropy stage (``codecs``, host), group encode and
decode (``encoder``) and progressive per-group streams (``segments``)."""

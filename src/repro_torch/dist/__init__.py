"""Distributed-training helpers; so far the single-device numerics of the
int8 gradient wire (`compress.fake_compress`)."""

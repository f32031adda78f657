"""Sink pipeline middlewares (the port's copy of
``transferia_tpu/middlewares/``).

Two combinator shapes: a Middleware wraps a Sinker into a Sinker, an
AsyncMiddleware an AsyncSink into an AsyncSink.  factories/sink.py
assembles them in the reference's order.
"""

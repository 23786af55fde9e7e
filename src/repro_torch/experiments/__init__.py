"""Shared experimental substrate (``fraud_world``)."""

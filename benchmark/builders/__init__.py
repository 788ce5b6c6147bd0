"""Builders of the program under test, one module a kind, named by a
configuration's ``builder`` key."""

"""Seconds from the start of the process to the start of the window:
imports, inputs, plans, the program's objects, kernel builds and
warm-up."""


def read(ctx):
    return ctx["setup_s"]

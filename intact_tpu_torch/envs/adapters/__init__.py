"""Env adapters: simulator obs dict -> model inputs, model actions -> sim
actions. numpy and the port's host codec on the serving host, never on the card."""

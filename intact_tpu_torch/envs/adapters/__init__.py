"""Env adapters: simulator obs dict -> model inputs, model actions -> sim
actions. Pure numpy/cv2 on the serving host, never on the card."""

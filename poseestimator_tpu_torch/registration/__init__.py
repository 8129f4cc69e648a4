"""Rigid registration: Horn/QUEST alignment and point-to-point ICP."""

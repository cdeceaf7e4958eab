"""Launchers: the serve and train drivers."""

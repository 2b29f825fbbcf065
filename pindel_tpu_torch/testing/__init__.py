"""Scenes, simulator and golden reports for checking the port."""

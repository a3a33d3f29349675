"""The scene generator and the traffic files it reads."""

"""Log-mel front-end."""

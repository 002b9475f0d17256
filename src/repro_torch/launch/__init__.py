"""Launchers of the port: DONN serving (`serve_donn`) and LM serving (`serve`)."""

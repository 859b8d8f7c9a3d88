"""Launchers (the reference's ``launch``): the training loop and the
serving mesh (``mesh.make_serving_mesh``). The production meshes and the
dry-run tools wait for the packed gradient wire and the dry run."""

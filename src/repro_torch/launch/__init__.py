"""Launchers (the reference's ``launch``): the training loop, the serving
mesh (``mesh.make_serving_mesh``) and the process meshes
(``mesh.make_mesh``, ``mesh.make_test_mesh``). The production meshes and
the dry-run tools wait for the dry run."""

from signalalign_jax.models.pore_model import PoreModel  # noqa: F401
